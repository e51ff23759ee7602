// GF(2^8) constant-matrix multiply for Hopper (sm_90a) as an XOR network
// of doubling chains, batched:
//     out[v][i, :] = XOR_j  coef[i][j] * in[v][j, :]      (field 0x11D)
// for V entries of (S, B) uint8 input -> V entries of (R, B) uint8 output,
// R and S up to 16.
//
// Replaces seaweedfs_tpu/ops/rs_jax.py::make_apply_xor (:70), the XLA
// program of `_multiples` (:40) and `_xor_network` (:54): the doubling
// chain x*2^k (k = 0..7, x*2 = (x << 1) ^ (0x1D if the top bit was set))
// and, for each output row, the XOR of the multiples its coefficients'
// bits select.  The batched entry is the counterpart of
// `jax.vmap(make_apply_xor(rows))` (parallel/mesh.py:71).  Unlike the TPU
// program, which XLA traces with the matrix baked in, this file takes the
// coefficients as a kernel argument (a __grid_constant__ struct, in the
// constant bank, read by every thread of a warp alike): one build serves
// every matrix, with no compile per plan.
//
// Doubling is linear over XOR, (a ^ b) * 2 = a*2 ^ b*2, so the chains can
// run on either side of the matrix; two kernels, each a template on R,
// one for each side.  The caller picks the side for the whole grid:
// ops/rs_xor.py::horner_side takes the side of fewer operations, the
// outputs' for every shape with 4 or more sources and the sources' for a
// tall matrix of 1-3 (R > 1 at S = 1, R > 3 at S = 2, R > 13 at S = 3),
// as the times of both kernels on the card bear out (PERF.md):
//
//  * gf_xor_horner, the chains on the outputs (every RS(10,4) parity and
//    decode plan): Horner's rule over the bit index,
//    out_i = (..(y_i7 * 2 ^ y_i6) * 2 ..) ^ y_i0, y_ik = XOR of the x_j
//    whose coefficient c_ij has bit k set: R chains instead of S.  Each
//    thread owns 16 columns (4 words of 4 bytes).  The
//    coefficient bits are not tested: a test cannot skip work here, since
//    the compiler turns a short branch into predicated XORs, which issue
//    whether the bit is set or not.  Instead each thread writes, for each
//    group of 4 sources, the 16 XOR combinations of their chunks into its
//    own entries of shared memory (walked in Gray-code order, one XOR an
//    entry), and y_ik is then one 16-byte read per group, at an offset the
//    launcher packs per (k, i, group) into the argument.  Up to R = 8 the
//    8 steps are unrolled, so the offsets sit at fixed addresses and are
//    read on the warp-uniform datapath.  Shared memory (576 bytes a
//    thread at S = 10) bounds the threads a SM can hold, so each block
//    walks the columns at a stride of the grid, as many blocks as the
//    card holds, and each thread loads the next chunk's sources while it
//    computes the current one.
//  * gf_xor_sources, the chains on the sources, as the JAX program
//    writes them: each source row (rolled) walks x*2^k, k = 0..7, and each
//    output whose coefficient has bit k set XORs the multiple in (a
//    predicated XOR a bit).
//
// A doubling of a word takes 4 operations: (x & 0x7F7F7F7F) << 1, then
// 0x1D XORed into each byte whose top bit was set, through one byte
// permute that spreads each byte's sign over the byte (`prmt` with the
// sign-replicate selector), the last AND and XOR one LOP3.
//
// Bound: the function's, its bytes, (S + R) * B * V over 3.35 TB/s:
// 0.070114 ms for RS(10,4) parity at 16 MiB per shard.  Per 16 columns
// the output-side kernel issues for that matrix 7 doublings of 16 words (4
// operations each), 30 XOR steps of 4 words to build the 3 groups' tables
// (4, 4 and 2 sources), and 4 XORs for each of the 8 * 4 * 3 reads:
// 448 + 120 + 384 = 952 operations per 160 input bytes, 6.0 a byte
// (rs_xor.xor_ops; the chains on the sources, a test and 4 predicated
// XORs a bit, would issue 17.0), 0.0597 ms at the card's 32-bit integer
// rate, and 132 shared accesses of 16 bytes.  PERF.md holds its measured
// time beside the bound.
//
// Access paths (`mode`, uniform over the grid, chosen by the launcher):
// 2 = 16-byte vector loads and stores (every row start, row stride and
// entry stride 16-byte aligned), 1 = 4-byte words, 0 = bytes.  Only a
// thread whose chunk ends past column B takes the byte path, masked, so no
// path reads or writes past column B.  blockIdx.y selects the entry; past
// 65535 entries each block walks entries y, y + gridDim.y, ...
// Output entries must not overlap (the launcher's caller allocates them).

#ifndef GF_HOST_TEST  // tests compile the kernels with g++, see below
#include <cuda_runtime.h>
#include <stdint.h>
#endif

typedef unsigned int u32;
typedef unsigned char u8;
typedef long long i64;

#define XOR_THREADS 256        // the source-side kernel's block
#define XOR_HORNER_THREADS 64  // the output-side kernel's block
#define XOR_WORDS 4                // 32-bit words per thread and row
#define XOR_CHUNK (4 * XOR_WORDS)  // columns per thread
#define XOR_MAX 16                 // the largest R and S
#define XOR_GROUPS (XOR_MAX / 4)   // groups of 4 sources
#define XOR_TABLE 16               // XOR combinations of a group's 4

struct GfCoef {
  u8 c[XOR_MAX * XOR_MAX];  // coef[i][j] at c[i * XOR_MAX + j]
  // off[k][i][g]: the byte offset in shared memory, from the thread's own
  // first entry, of the combination of group g's sources that step k
  // selects for output i: entry g * 16 + n, bit b of n set iff
  // coef[i][4g + b] has bit k
  u32 off[8][XOR_MAX][XOR_GROUPS];
};

typedef u32 Chunk[XOR_WORDS];

// each byte of x -> 0xFF if its top bit is set, else 0x00
__device__ __forceinline__ u32 sign_bytes(u32 x) {
#ifdef GF_HOST_TEST
  u32 s = 0;
  for (int b = 0; b < 4; ++b)
    if ((x >> (8 * b + 7)) & 1u) s |= 0xFFu << (8 * b);
  return s;
#else
  u32 s;
  asm("prmt.b32 %0, %1, %1, %2;" : "=r"(s) : "r"(x), "n"(0xBA98));
  return s;
#endif
}

// x * 2 in GF(2^8) for each of the four bytes of x: 4 operations
__device__ __forceinline__ u32 gf_double4(u32 x) {
  return ((x & 0x7F7F7F7Fu) << 1) ^ (sign_bytes(x) & 0x1D1D1D1Du);
}

__device__ __forceinline__ void double_chunk(Chunk& x) {
#pragma unroll
  for (int w = 0; w < XOR_WORDS; ++w) x[w] = gf_double4(x[w]);
}

__device__ __forceinline__ void xor_into(Chunk& acc, const Chunk& x) {
#pragma unroll
  for (int w = 0; w < XOR_WORDS; ++w) acc[w] ^= x[w];
}

// the byte path of a chunk from c0, masked at column B (a chunk that ends
// past B): out of line, so the unrolled loads stay small
__device__ __noinline__ uint4 load_bytes(const u8* row, i64 c0, i64 B) {
  u32 x[4] = {0u, 0u, 0u, 0u};
  for (int c = 0; c < XOR_CHUNK; ++c)
    if (c0 + c < B) x[c >> 2] |= (u32)row[c0 + c] << (8 * (c & 3));
  uint4 a;
  a.x = x[0]; a.y = x[1]; a.z = x[2]; a.w = x[3];
  return a;
}

__device__ __noinline__ void store_bytes(uint4 a, u8* row, i64 c0, i64 B) {
  const u32 y[4] = {a.x, a.y, a.z, a.w};
  for (int c = 0; c < XOR_CHUNK; ++c)
    if (c0 + c < B) row[c0 + c] = (u8)(y[c >> 2] >> (8 * (c & 3)));
}

__device__ __forceinline__ void load_chunk(Chunk& x, const u8* row, i64 c0,
                                           i64 B, int mode) {
  const bool full = c0 + XOR_CHUNK <= B;
  uint4 a;
  if (full && mode == 2) {
    a = *reinterpret_cast<const uint4*>(row + c0);
  } else if (full && mode == 1) {
    const u32* w = reinterpret_cast<const u32*>(row + c0);
    a.x = w[0]; a.y = w[1]; a.z = w[2]; a.w = w[3];
  } else {
    a = load_bytes(row, c0, B);
  }
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}

__device__ __forceinline__ void store_chunk(const Chunk& y, u8* row, i64 c0,
                                            i64 B, int mode) {
  const bool full = c0 + XOR_CHUNK <= B;
  uint4 a;
  a.x = y[0]; a.y = y[1]; a.z = y[2]; a.w = y[3];
  if (full && mode == 2) {
    *reinterpret_cast<uint4*>(row + c0) = a;
  } else if (full && mode == 1) {
    u32* w = reinterpret_cast<u32*>(row + c0);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  } else {
    store_bytes(a, row, c0, B);
  }
}

// the chunk at c0 of each of the S source rows (rows past S untouched)
__device__ __forceinline__ void load_sources(Chunk (&x)[XOR_MAX],
                                             const u8* src, i64 in_stride,
                                             i64 c0, i64 B, int S, int mode) {
  const u8* row = src + c0;
  if (mode == 2 && c0 + XOR_CHUNK <= B) {  // the main path: 16-byte loads
#pragma unroll
    for (int j = 0; j < XOR_MAX; ++j) {
      if (j < S) {
        const uint4 a = *reinterpret_cast<const uint4*>(row);
        x[j][0] = a.x; x[j][1] = a.y; x[j][2] = a.z; x[j][3] = a.w;
      }
      row += in_stride;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < XOR_MAX; ++j)
    if (j < S) load_chunk(x[j], src + (i64)j * in_stride, c0, B, mode);
}

// shared memory entries of the output-side kernel: the first `groups`
// groups of 16, the last group only as many as its sources need
static inline int table_entries(int srcs) {
  const int groups = (srcs + 3) / 4;
  return XOR_TABLE * (groups - 1) + (1 << (srcs - 4 * (groups - 1)));
}

#ifdef GF_HOST_TEST
static uint4 xor_table_host[XOR_GROUPS * XOR_TABLE * XOR_HORNER_THREADS];
static inline uint4* xor_table() { return xor_table_host; }
static inline uint4 make_uint4(u32 x, u32 y, u32 z, u32 w) {
  uint4 a;
  a.x = x; a.y = y; a.z = z; a.w = w;
  return a;
}
#else
__device__ __forceinline__ uint4* xor_table() {
  extern __shared__ uint4 xor_table_smem[];
  return xor_table_smem;
}
#endif

// Horner's rule over the bit index, the chains on the R outputs.
// A block walks the column blocks blockIdx.x, blockIdx.x + gridDim.x, ...
// of its entries, each thread the next block's sources in flight while it
// computes the current one.  The walk's bounds are the block's, so every
// loop is uniform over the warp and the steps' offsets come from the
// uniform datapath; a thread past column B loads and stores nothing.
template <int R>
__global__ void __launch_bounds__(XOR_HORNER_THREADS)
gf_xor_horner(const u8* __restrict__ in, i64 in_stride, i64 in_bstride,
              u8* __restrict__ out, i64 out_stride, i64 out_bstride, i64 B,
              i64 V, int S, int mode, const __grid_constant__ GfCoef coef) {
  const i64 per_block = (i64)XOR_HORNER_THREADS * XOR_CHUNK;
  const i64 first = (i64)blockIdx.x * per_block;
  const i64 step = (i64)gridDim.x * per_block;
  const i64 lane = (i64)threadIdx.x * XOR_CHUNK;
  // entry e of this thread at tab[e * XOR_HORNER_THREADS + threadIdx.x]
  uint4* mine = xor_table() + threadIdx.x;
  const int groups = (S + 3) >> 2;
#pragma unroll 1
  for (i64 v = blockIdx.y; v < V; v += gridDim.y) {
    const u8* src = in + v * in_bstride;
    u8* dst = out + v * out_bstride;
    Chunk x[XOR_MAX];  // rows past S stay zero
#pragma unroll
    for (int j = 0; j < XOR_MAX; ++j)
#pragma unroll
      for (int w = 0; w < XOR_WORDS; ++w) x[j][w] = 0u;
    load_sources(x, src, in_stride, first + lane, B, S, mode);
#pragma unroll 1
    for (i64 base = first; base < B; base += step) {
      const i64 c0 = base + lane;
      // each group's 16 XOR combinations, entry n the XOR of x[4g + b] for
      // the set bits b of n: walked in Gray-code order, n = i ^ (i >> 1),
      // each entry one XOR from the one before (one chunk live)
#pragma unroll
      for (int g = 0; g < XOR_GROUPS; ++g) {
        if (g >= groups) break;
        const int live = S - 4 * g;  // the group's sources, 4 if more
        const int entries = live >= 4 ? XOR_TABLE : 1 << live;
        Chunk t;
#pragma unroll
        for (int w = 0; w < XOR_WORDS; ++w) t[w] = 0u;
        mine[g * XOR_TABLE * XOR_HORNER_THREADS] = make_uint4(0u, 0u, 0u,
                                                              0u);
#pragma unroll
        for (int i = 1; i < XOR_TABLE; ++i) {
          if (i >= entries) break;
          const int b = (i & 1) ? 0 : (i & 2) ? 1 : (i & 4) ? 2 : 3;
          xor_into(t, x[4 * g + b]);
          mine[(g * XOR_TABLE + (i ^ (i >> 1))) * XOR_HORNER_THREADS] =
              make_uint4(t[0], t[1], t[2], t[3]);
        }
      }
      // the next block's sources, in flight during this one's steps
      if (base + step < B)
        load_sources(x, src, in_stride, c0 + step, B, S, mode);
      Chunk acc[R];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int w = 0; w < XOR_WORDS; ++w) acc[i][w] = 0u;
      // the steps unrolled: each step's offsets sit at fixed addresses of
      // the argument, read on the uniform datapath.  Past 8 outputs (no
      // RS(10,4) plan) they stay rolled, to keep the file's build short.
#pragma unroll(R <= 8 ? 8 : 1)
      for (int k = 7; k >= 0; --k) {
        if (k < 7) {
#pragma unroll
          for (int i = 0; i < R; ++i) double_chunk(acc[i]);
        }
#pragma unroll
        for (int g = 0; g < XOR_GROUPS; ++g) {
          if (g >= groups) break;
          uint4 a[R];  // the R reads of a group in flight together
#pragma unroll
          for (int i = 0; i < R; ++i)
            a[i] = *reinterpret_cast<const uint4*>(
                reinterpret_cast<const u8*>(mine) + coef.off[k][i][g]);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            acc[i][0] ^= a[i].x; acc[i][1] ^= a[i].y; acc[i][2] ^= a[i].z;
            acc[i][3] ^= a[i].w;
          }
        }
      }
      if (mode == 2 && c0 + XOR_CHUNK <= B) {  // the main path
        u8* row = dst + c0;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          *reinterpret_cast<uint4*>(row) =
              make_uint4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          row += out_stride;
        }
      } else {
#pragma unroll
        for (int i = 0; i < R; ++i)
          store_chunk(acc[i], dst + (i64)i * out_stride, c0, B, mode);
      }
    }
  }
}

// The chain on each source row in turn, its multiples XORed into
// the outputs whose coefficients select them; one chunk a thread
template <int R>
__global__ void __launch_bounds__(XOR_THREADS)
gf_xor_sources(const u8* __restrict__ in, i64 in_stride, i64 in_bstride,
               u8* __restrict__ out, i64 out_stride, i64 out_bstride, i64 B,
               i64 V, int S, int mode, const __grid_constant__ GfCoef coef) {
  const i64 c0 =
      ((i64)blockIdx.x * XOR_THREADS + (i64)threadIdx.x) * XOR_CHUNK;
  if (c0 >= B) return;
#pragma unroll 1
  for (i64 v = blockIdx.y; v < V; v += gridDim.y) {
    const u8* src = in + v * in_bstride;
    Chunk acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int w = 0; w < XOR_WORDS; ++w) acc[i][w] = 0u;
#pragma unroll 1
    for (int j = 0; j < S; ++j) {
      Chunk x;
      load_chunk(x, src + (i64)j * in_stride, c0, B, mode);
      u32 cj[R];
#pragma unroll
      for (int i = 0; i < R; ++i) cj[i] = coef.c[i * XOR_MAX + j];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
#pragma unroll
        for (int i = 0; i < R; ++i)
          if ((cj[i] >> k) & 1u) xor_into(acc[i], x);
        if (k < 7) double_chunk(x);
      }
    }
    u8* dst = out + v * out_bstride;
#pragma unroll
    for (int i = 0; i < R; ++i)
      store_chunk(acc[i], dst + (i64)i * out_stride, c0, B, mode);
  }
}

// the access path for these pointers and strides: 2, 1 or 0 (see above)
static inline int access_mode(const void* in, i64 in_stride, i64 in_bstride,
                              const void* out, i64 out_stride,
                              i64 out_bstride) {
  const unsigned long long align =
      (unsigned long long)(uintptr_t)in | (unsigned long long)in_stride |
      (unsigned long long)in_bstride | (unsigned long long)(uintptr_t)out |
      (unsigned long long)out_stride | (unsigned long long)out_bstride;
  return (align & 15ull) == 0 ? 2 : (align & 3ull) == 0 ? 1 : 0;
}

// the (rows, srcs) row-major matrix `coef` in the kernels' layout
static inline GfCoef pack_coef(int rows, int srcs, const unsigned char* coef) {
  GfCoef c;
  for (int i = 0; i < XOR_MAX * XOR_MAX; ++i)
    c.c[i] = i / XOR_MAX < rows && i % XOR_MAX < srcs
                 ? coef[i / XOR_MAX * srcs + i % XOR_MAX]
                 : 0;
  for (int k = 0; k < 8; ++k)
    for (int i = 0; i < XOR_MAX; ++i)
      for (int g = 0; g < XOR_GROUPS; ++g) {
        int n = 0;
        for (int b = 0; b < 4; ++b)
          n |= ((c.c[i * XOR_MAX + 4 * g + b] >> k) & 1) << b;
        c.off[k][i][g] =
            (u32)(g * XOR_TABLE + n) * XOR_HORNER_THREADS * 16;
      }
  return c;
}

#ifndef GF_HOST_TEST
#include <atomic>

#define XOR_DEVICES 64  // devices whose block counts are kept

static const void* kernel_for(int rows, bool horner) {
  switch (rows) {
#define XOR_CASE(n)                                      \
  case n:                                                \
    return horner ? (const void*)gf_xor_horner<n>        \
                  : (const void*)gf_xor_sources<n>;
    XOR_CASE(1) XOR_CASE(2) XOR_CASE(3) XOR_CASE(4) XOR_CASE(5) XOR_CASE(6)
    XOR_CASE(7) XOR_CASE(8) XOR_CASE(9) XOR_CASE(10) XOR_CASE(11)
    XOR_CASE(12) XOR_CASE(13) XOR_CASE(14) XOR_CASE(15) XOR_CASE(16)
#undef XOR_CASE
  }
  return nullptr;
}

// blocks of the output-side kernel for `rows` resident on all of
// `device`'s SMs at once with `srcs` sources' tables; counted once per
// device and plan shape, then read from the table.  The first count also
// raises the kernel's shared-memory limit to what 16 sources need, the
// same value from every thread, so no launch sees it lowered.  Returns a
// cudaError_t, 0 on success.
static int resident_blocks(int device, int rows, int srcs, i64* slots) {
  static std::atomic<int> kept[XOR_DEVICES][XOR_MAX][XOR_MAX];
  std::atomic<int>* slot = device >= 0 && device < XOR_DEVICES
                               ? &kept[device][rows - 1][srcs - 1] : nullptr;
  int n = slot ? slot->load(std::memory_order_relaxed) : 0;
  if (n == 0) {
    const void* kernel = kernel_for(rows, true);
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        table_entries(XOR_MAX) * XOR_HORNER_THREADS * 16);
    int sms = 0, per_sm = 0;
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, XOR_HORNER_THREADS,
          (size_t)table_entries(srcs) * XOR_HORNER_THREADS * 16);
    if (e != cudaSuccess) return (int)e;
    n = sms * (per_sm > 0 ? per_sm : 1);
    if (slot) slot->store(n, std::memory_order_relaxed);
  }
  *slots = n;
  return 0;
}

// coef: the (rows, srcs) matrix, row-major, in host memory.  in/out: device
// pointers on CUDA device `device`; entry v's input row j starts at
// in + v*in_bstride + j*in_stride, its output row i at
// out + v*out_bstride + i*out_stride; B columns each, V entries.  horner:
// 1 runs the chains on the outputs (gf_xor_horner), 0 on the sources
// (gf_xor_sources).  Launches on `stream` and returns the launch's
// cudaError_t (0 on success); B == 0 or V == 0 launches nothing.  This
// library links its own CUDA runtime, whose current device is per thread,
// so it sets the device first.
extern "C" int gf_xor_launch(const void* in, i64 in_stride, i64 in_bstride,
                             void* out, i64 out_stride, i64 out_bstride,
                             i64 B, i64 V, int rows, int srcs,
                             const unsigned char* coef, int horner,
                             int device, void* stream) {
  if (rows < 1 || rows > XOR_MAX || srcs < 1 || srcs > XOR_MAX || B < 0 ||
      V < 0 || in_bstride < 0 || (srcs > 1 && in_stride < B) ||
      (rows > 1 && out_stride < B) ||
      (V > 1 && out_bstride < (rows - 1) * out_stride + B) ||
      (horner != 0 && horner != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || V == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = horner ? XOR_HORNER_THREADS : XOR_THREADS;
  const i64 per_block = (i64)threads * XOR_CHUNK;
  i64 blocks = (B + per_block - 1) / per_block;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  const unsigned gy = (unsigned)(V < 65535 ? V : 65535);
  size_t smem = 0;
  if (horner) {
    // as many blocks as the card holds at once, each walking its chunks
    smem = (size_t)table_entries(srcs) * threads * 16;
    i64 slots = 0;
    const int counted = resident_blocks(device, rows, srcs, &slots);
    if (counted != 0) return counted;
    const i64 resident = (slots + gy - 1) / gy;
    if (resident < blocks) blocks = resident > 0 ? resident : 1;
  }
  GfCoef c = pack_coef(rows, srcs, coef);
  int mode = access_mode(in, in_stride, in_bstride, out, out_stride,
                         out_bstride);
  int s = srcs;
  const dim3 grid((unsigned)blocks, gy);
  void* args[] = {&in, &in_stride, &in_bstride, &out, &out_stride,
                  &out_bstride, &B, &V, &s, &mode, &c};
  err = cudaLaunchKernel(kernel_for(rows, horner != 0), grid, dim3(threads),
                         args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves its error behind
    return (int)err;
  }
  return (int)cudaGetLastError();
}
#endif  // GF_HOST_TEST
