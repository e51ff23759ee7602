// GF(2^8) constant-matrix multiply for Hopper (sm_90a) in bit-planes on
// the int8 tensor cores, fused into one kernel, gf_bitplane_mma:
//     out = pack((bit_matrix(M) @ unpack(in)) & 1)
// for an (R, S) uint8 matrix M and (S, B) uint8 input -> (R, B) uint8,
// R and S from 1 to 16.  Over GF(2) the codec is linear in bits: plane
// 8j + l of the input holds bit l of source row j, `gf256.bit_matrix(M)`
// is the (8R, 8S) 0/1 matrix of the map, and bit k of output byte (i, c)
// is the parity of the product's entry (8i + k, c).
//
// Replaces seaweedfs_tpu/ops/rs_jax.py::make_apply_mxu (:81), one XLA
// program for the TPU's matrix unit, and the per-device step of
// seaweedfs_tpu/parallel/mesh.py::distributed_reconstruct (:156) with its
// `_bit_unpack` (:138) and `_bit_pack` (:146).  The reference sums int32
// partials over devices before the `& 1`; the port's distributed decode
// XORs the packed partials instead, since (sum_d p_d) & 1 = XOR_d (p_d & 1).
//
// Bound: the function's bytes, (S + R) * B over 3.35 TB/s (0.070 ms for
// RS(10,4) parity at 16 MiB per shard), above the tensor work (2 * 8R *
// 8S * B int8 operations, 0.043 ms at 1979 TOP/s).  An unfused route (the
// planes written and read back as 8S*B int8, the sums as 32R*B bytes of
// int32) moves ~25x those bytes.  Here neither the planes nor the sums
// leave the SM: the input tile is staged in shared memory, the planes are
// made in registers as the product's A operand, the sums stay in the
// accumulators and only packed bytes are stored.
//
// The product is wgmma.mma_async m64n32k32 .s32.s8.s8, A from registers,
// B from shared memory, with data columns as its M axis, planes as K and
// output planes as N:
//   * K order.  Source rows go in groups of 4, one k32 step each (rows
//     past S zero).  K index 4u + m is bit u of row 4q + m, so the A
//     register a thread owns, 4 consecutive K of one column, is the
//     column's word of the group's 4 bytes shifted right by u: `x >> u`.
//     Only each byte's low bit is the plane; the bits above it are junk,
//     harmless because only the parity of each sum is kept and the weights
//     below are powers of two (a sum's parity is the XOR of its terms' low
//     bits).
//   * N order.  N = 32 is one group of 4 output rows: column 8c + 2t + e
//     is plane 2c + e of output row t, so lane (g, t) of a warp, which
//     holds accumulators N 8c + 2t + e (c = 0..3, e = 0..1) of its rows,
//     holds all 8 planes of output row t's bytes in those columns.  No
//     shuffle gathers a byte.  R rounds up to a multiple of 4; the padded
//     rows are zero.
//   * Weights.  B's column for output plane k holds bit_matrix * 2^k (-128
//     for k = 7), so the sum for plane k is 2^k times an integer: its bits
//     below k are zero and bit k is the parity.  A byte is then 7 merges
//     (v & (2^k - 1)) | sum_k, one LOP3 each.
// B, the bit matrix transposed and weighted, is one 1024-byte tile per
// (source group, output group) in wgmma's K-major layout without swizzle:
// core matrices of 8 N rows x 16 K bytes, 128 bytes apart along K (the
// descriptor's leading offset) and 256 along N (its stride offset).  The
// wrapper builds the tiles once per matrix (rs_bitplane.operand_tiles) and
// each block copies them to shared memory.
//
// A block is one warpgroup (4 warps) and walks tiles of 256 columns,
// grid-stride, the grid sized to fill every SM; warp w gives rows 16w ..
// 16w + 15 of each of the tile's 4 m64 chunks.  Per tile: (1) the tile's
// S x 256 input bytes, copied asynchronously (cp.async) into a ring of
// BPM_STAGES slots BPM_STAGES - 1 tiles ahead, are transposed (byte
// permutes) into the column words of each 4-row group; (2) each k step's
// 4 wgmmas (one per chunk) for each group of 4 output rows, the merged
// bytes going to an (R, 256) tile; (3) the block stores the tile's rows.
// Shared memory is sized per plan (17 KB for RS(10,4)).  Access paths,
// chosen by the launcher from pointers and strides as csrc/gf_xor.cu's
// access_mode chooses: 16-byte copies and stores where the rows allow,
// else 4-byte words, else bytes (plain loads for the input).  The ragged
// last tile masks: nothing is read or written past column B.
//
// Measured (PERF.md): 0.23 ms for RS(10,4) parity at 16 MiB per shard, 31 %
// of the bound.  Each phase of a tile is a latency chain (a wgmma wait per
// k step, loads to permutes to stores) that 4-5 blocks a SM hide only in
// part; more blocks (128-column tiles) and all steps before one wait were
// both slower.
//
// Under GF_HOST_TEST the same source compiles with g++: the tests run the
// steps thread by thread (the product for the warpgroup's 128 threads at
// once, NL = 128) with a plain emulation of wgmma's operand layouts.

#ifndef GF_HOST_TEST  // tests compile the kernel with g++
#include <cuda_runtime.h>
#include <stdint.h>
#include <atomic>
#define NL 1  // threads one call of the product computes: its own
#else
#define NL 128  // the host runs the warpgroup's 128 threads together
#endif

typedef unsigned int u32;
typedef unsigned char u8;
typedef signed char i8;
typedef long long i64;
typedef unsigned long long u64;

#define BPM_MAX 16                       // the largest R and S
#define BPM_THREADS 128                  // one warpgroup a block
#define BPM_TILE 256                     // columns a tile
#define BPM_MT (BPM_TILE / 64)           // its m64 chunks
#define BPM_STAGES 4                     // tiles in the input ring
#define BPM_OUT_PITCH (BPM_TILE + 16)    // bank-spread, 16-byte rows
#define BPM_B_TILE 1024                  // bytes of one B operand tile
#define BPM_LBO 128                      // B: core matrices along K
#define BPM_SBO 256                      // B: core matrices along N

// the plan's shared memory, each part 16-byte aligned: the B tiles, the
// input ring, the column words and the output tile
struct Smem {
  u8* bop;   // [groups][ngroups][BPM_B_TILE]
  u8* ring;  // [BPM_STAGES][S][BPM_TILE]
  u32* grp;  // [groups][BPM_TILE]
  u8* outs;  // [R][BPM_OUT_PITCH]
};

static inline int smem_bytes(int S, int R) {
  const int groups = (S + 3) / 4, ngroups = (R + 3) / 4;
  return groups * ngroups * BPM_B_TILE + BPM_STAGES * S * BPM_TILE +
         groups * BPM_TILE * 4 + R * BPM_OUT_PITCH;
}

__device__ __forceinline__ Smem carve(u8* base, int S, int R) {
  const int groups = (S + 3) / 4, ngroups = (R + 3) / 4;
  Smem m;
  m.bop = base;
  m.ring = m.bop + groups * ngroups * BPM_B_TILE;
  m.grp = reinterpret_cast<u32*>(m.ring + BPM_STAGES * S * BPM_TILE);
  m.outs = reinterpret_cast<u8*>(m.grp + groups * BPM_TILE);
  return m;
}

// bytes of x and y selected by s (PTX prmt, default mode)
__device__ __forceinline__ u32 byte_perm(u32 x, u32 y, u32 s) {
#ifdef GF_HOST_TEST
  const u64 xy = (u64)y << 32 | x;
  u32 r = 0;
  for (int i = 0; i < 4; ++i)
    r |= (u32)((xy >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i);
  return r;
#else
  return __byte_perm(x, y, s);
#endif
}

// cp.async of `bytes` (4 or 16) from global to shared memory, of which the
// first `src_bytes` are read and the rest zero-filled
__device__ __forceinline__ void copy_async(u8* dst, const u8* src, int bytes,
                                           int src_bytes) {
#ifdef GF_HOST_TEST
  for (int e = 0; e < bytes; ++e) dst[e] = e < src_bytes ? src[e] : 0;
#else
  const u32 d = (u32)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
#endif
}

__device__ __forceinline__ void copy_commit() {
#ifndef GF_HOST_TEST
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// wait until at most N of this thread's newest copy groups are in flight
template <int N>
__device__ __forceinline__ void copy_wait() {
#ifndef GF_HOST_TEST
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

// The B operand of a wgmma: the descriptor of a tile in shared memory
// (K-major, no swizzle: start address, leading and stride byte offsets,
// each >> 4).  On the host, the tile's address itself.
__device__ __forceinline__ u64 b_desc(const u8* tile) {
#ifdef GF_HOST_TEST
  return (u64)(uintptr_t)tile;
#else
  const u64 addr = (u64)__cvta_generic_to_shared(tile);
  return ((addr & 0x3FFFF) >> 4) | ((u64)(BPM_LBO >> 4) << 16) |
         ((u64)(BPM_SBO >> 4) << 32);
#endif
}

// D = A * B (+ D if accumulate) on the tensor cores, for the NL threads of
// the warpgroup: wgmma m64n32k32 .s32.s8.s8.  As PTX lays out the
// operands, thread (warp w, lane (g, t) = (lane >> 2, lane & 3)) holds A
// row 16w + g in registers 0 and 2 and row 16w + g + 8 in 1 and 3, K
// 4t..4t+3 (+16 in 2 and 3), the element of K 4t + e in byte e; and D[i]
// at row 16w + g + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2t + (i & 1).  B
// element (n, k) sits at (n / 8) * SBO + (k / 16) * LBO + (n % 8) * 16 +
// k % 16 of its tile.
__device__ __forceinline__ void wgmma(int (&d)[NL][16], const u32 (&a)[NL][4],
                                      u64 desc, int accumulate) {
#ifdef GF_HOST_TEST
  const u8* tile = reinterpret_cast<const u8*>((uintptr_t)desc);
  i8 A[64][32];
  for (int tid = 0; tid < 128; ++tid) {
    const int w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
    for (int r = 0; r < 4; ++r)
      for (int e = 0; e < 4; ++e)
        A[16 * w + g + 8 * (r & 1)][4 * t + e + 16 * (r >> 1)] =
            (i8)(a[tid][r] >> (8 * e));
  }
  for (int tid = 0; tid < 128; ++tid) {
    const int w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
    for (int i = 0; i < 16; ++i) {
      const int row = 16 * w + g + 8 * ((i >> 1) & 1);
      const int n = 8 * (i >> 2) + 2 * t + (i & 1);
      int s = accumulate ? d[tid][i] : 0;
      for (int k = 0; k < 32; ++k)
        s += (int)A[row][k] *
             (int)(i8)tile[(n / 8) * BPM_SBO + (k / 16) * BPM_LBO +
                           (n % 8) * 16 + k % 16];
      d[tid][i] = s;
    }
  }
#else
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[0][4]), "+r"(d[0][5]), "+r"(d[0][6]), "+r"(d[0][7]),
        "+r"(d[0][8]), "+r"(d[0][9]), "+r"(d[0][10]), "+r"(d[0][11]),
        "+r"(d[0][12]), "+r"(d[0][13]), "+r"(d[0][14]), "+r"(d[0][15])
      : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]), "l"(desc),
        "r"(accumulate));
#endif
}

// wgmma's ordering: fence before a step reads registers written since,
// commit the step's group, wait for it before its accumulators are read
__device__ __forceinline__ void wgmma_fence() {
#ifndef GF_HOST_TEST
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
#ifndef GF_HOST_TEST
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#endif
}

// Step 1a: the tile at column c0 of the S input rows into a ring slot,
// zero past column B: 16-byte or 4-byte asynchronous copies (mode 2, 1),
// else plain byte loads (mode 0).
__device__ __forceinline__ void fetch(u8* slot, const u8* in, i64 in_stride,
                                      int S, i64 B, i64 c0, int mode,
                                      int tid) {
  const int size = mode == 2 ? 16 : mode == 1 ? 4 : 1;
  const int shift = mode == 2 ? 4 : mode == 1 ? 6 : 8;  // log2(256 / size)
#pragma unroll 1
  for (int idx = tid; idx < S << shift; idx += BPM_THREADS) {
    const int j = idx >> shift, c = size * (idx & ((1 << shift) - 1));
    const i64 left = B - c0 - c;
    const int n = left <= 0 ? 0 : left < size ? (int)left : size;
    const u8* src = in + j * in_stride + (n ? c0 + c : 0);
    if (mode)
      copy_async(slot + j * BPM_TILE + c, src, size, n);
    else
      slot[j * BPM_TILE + c] = n ? *src : (u8)0;
  }
}

// Step 1b: the slot transposed into column words: grp[q][c] holds the 4
// bytes of group q's rows in column c (rows past S zero).
__device__ __forceinline__ void transpose(const u8* slot, u32* grp, int S,
                                          int tid) {
  const int groups = (S + 3) / 4;
#pragma unroll 1
  for (int pair = tid; pair < groups * (BPM_TILE / 4); pair += BPM_THREADS) {
    const int q = pair / (BPM_TILE / 4), c = 4 * (pair % (BPM_TILE / 4));
    u32 w[4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
      w[m] = 4 * q + m < S ? *reinterpret_cast<const u32*>(
                                 slot + (4 * q + m) * BPM_TILE + c)
                           : 0u;
    const u32 lo01 = byte_perm(w[0], w[1], 0x5140);
    const u32 hi01 = byte_perm(w[0], w[1], 0x7362);
    const u32 lo23 = byte_perm(w[2], w[3], 0x5140);
    const u32 hi23 = byte_perm(w[2], w[3], 0x7362);
    uint4 x;
    x.x = byte_perm(lo01, lo23, 0x5410);
    x.y = byte_perm(lo01, lo23, 0x7632);
    x.z = byte_perm(hi01, hi23, 0x5410);
    x.w = byte_perm(hi01, hi23, 0x7632);
    *reinterpret_cast<uint4*>(grp + q * BPM_TILE + c) = x;
  }
}

// Step 2: the tile's product for threads tid0 .. tid0 + NL - 1 (the
// thread's own on the card): for each group of 4 output rows, one k step
// a source group, 4 wgmmas a step (one per m64 chunk), then each thread's
// bytes of output row 4ng + t, columns 64mt + 16w + g and + 8.
__device__ __forceinline__ void product(const u32* grp, const u8* bop,
                                        u8* outs, int S, int R, int tid0) {
  const int groups = (S + 3) / 4, ngroups = (R + 3) / 4;
#pragma unroll 1
  for (int ng = 0; ng < ngroups; ++ng) {
    int acc[BPM_MT][NL][16];
#pragma unroll 1
    for (int q = 0; q < groups; ++q) {
      // the A fragments: the group's column words shifted
      u32 a[BPM_MT][NL][4];
      for (int L = 0; L < NL; ++L) {
        const int tid = tid0 + L, w = tid >> 5;
        const int g = (tid & 31) >> 2, t = tid & 3;
#pragma unroll
        for (int mt = 0; mt < BPM_MT; ++mt) {
          const u32 x0 = grp[q * BPM_TILE + 64 * mt + 16 * w + g];
          const u32 x1 = grp[q * BPM_TILE + 64 * mt + 16 * w + g + 8];
          a[mt][L][0] = x0 >> t;
          a[mt][L][1] = x1 >> t;
          a[mt][L][2] = x0 >> (t + 4);
          a[mt][L][3] = x1 >> (t + 4);
        }
      }
      const u64 desc = b_desc(bop + (q * ngroups + ng) * BPM_B_TILE);
      wgmma_fence();
#pragma unroll
      for (int mt = 0; mt < BPM_MT; ++mt) wgmma(acc[mt], a[mt], desc, q);
      wgmma_commit_and_wait();
    }
    // output byte (4ng + t, column): plane k = 2c + e in acc[.][.][4c + e]
    // (row g) and [4c + 2 + e] (row g + 8); the sum of plane k is zero
    // below bit k and holds the plane at bit k
    for (int L = 0; L < NL; ++L) {
      const int tid = tid0 + L, w = tid >> 5;
      const int g = (tid & 31) >> 2, t = tid & 3;
      const int i = 4 * ng + t;
      if (i >= R) continue;
#pragma unroll
      for (int mt = 0; mt < BPM_MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          u32 v = (u32)acc[mt][L][2 * h];
#pragma unroll
          for (int k = 1; k < 8; ++k)
            v = (v & ((1u << k) - 1u)) |
                (u32)acc[mt][L][4 * (k >> 1) + 2 * h + (k & 1)];
          outs[i * BPM_OUT_PITCH + 64 * mt + 16 * w + g + 8 * h] = (u8)v;
        }
    }
  }
}

// Step 3: the tile's (R, cols) bytes to the output rows
__device__ __forceinline__ void store_out(const u8* outs, u8* out,
                                          i64 out_stride, int R, i64 B,
                                          i64 c0, int mode, int tid) {
  const i64 cols = B - c0 < BPM_TILE ? B - c0 : BPM_TILE;
#pragma unroll 1
  for (int idx = tid; idx < R * (BPM_TILE / 16); idx += BPM_THREADS) {
    const int i = idx / (BPM_TILE / 16), c = 16 * (idx % (BPM_TILE / 16));
    if (c >= cols) continue;
    const u8* src = outs + i * BPM_OUT_PITCH + c;
    u8* dst = out + i * out_stride + c0 + c;
    if (c + 16 <= cols && mode == 2) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else if (c + 16 <= cols && mode == 1) {
#pragma unroll
      for (int w = 0; w < 4; ++w)
        reinterpret_cast<u32*>(dst)[w] = reinterpret_cast<const u32*>(src)[w];
    } else {
      for (int e = 0; e < 16 && c + e < cols; ++e) dst[e] = src[e];
    }
  }
}

#ifndef GF_HOST_TEST
__global__ void __launch_bounds__(BPM_THREADS)
gf_bitplane_mma_kernel(const u8* __restrict__ in, i64 in_stride,
                       u8* __restrict__ out, i64 out_stride, int S, int R,
                       i64 B, const u32* __restrict__ tiles_b, int in_mode,
                       int out_mode) {
  extern __shared__ __align__(1024) u8 smem[];
  const Smem m = carve(smem, S, R);
  const int tid = threadIdx.x;
  const int words = (S + 3) / 4 * ((R + 3) / 4) * (BPM_B_TILE / 4);
  for (int i = tid; i < words; i += BPM_THREADS)
    reinterpret_cast<u32*>(m.bop)[i] = tiles_b[i];
  // the B tiles, written by plain stores, are read by wgmma's async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const i64 tiles = (B + BPM_TILE - 1) / BPM_TILE;
  // the first BPM_STAGES - 1 tiles in flight, one copy group each
#pragma unroll 1
  for (int k = 0; k < BPM_STAGES - 1; ++k) {
    const i64 tile = blockIdx.x + (i64)k * gridDim.x;
    if (tile < tiles)
      fetch(m.ring + k * S * BPM_TILE, in, in_stride, S, B, tile * BPM_TILE,
            in_mode, tid);
    copy_commit();
  }
  int slot = 0;
  for (i64 tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const i64 ahead = tile + (i64)(BPM_STAGES - 1) * gridDim.x;
    if (ahead < tiles)  // into the slot the last tile's transpose freed
      fetch(m.ring + (slot + BPM_STAGES - 1) % BPM_STAGES * S * BPM_TILE, in,
            in_stride, S, B, ahead * BPM_TILE, in_mode, tid);
    copy_commit();
    copy_wait<BPM_STAGES - 1>();  // this thread's copies of `tile` landed
    __syncthreads();              // and every thread's
    transpose(m.ring + slot * S * BPM_TILE, m.grp, S, tid);
    __syncthreads();
    product(m.grp, m.bop, m.outs, S, R, tid);
    __syncthreads();
    store_out(m.outs, out, out_stride, R, B, tile * BPM_TILE, out_mode, tid);
    slot = (slot + 1) % BPM_STAGES;
  }
}
#endif

// the access path for rows at `p` of stride `stride`: 2 = 16-byte
// copies or stores, 1 = 4-byte words, 0 = bytes
static inline int access_mode(const void* p, i64 stride) {
  const u64 align = (u64)(uintptr_t)p | (u64)stride;
  return (align & 15ull) == 0 ? 2 : (align & 3ull) == 0 ? 1 : 0;
}

#ifndef GF_HOST_TEST
#define BPM_DEVICES 64  // devices whose block counts are kept

// blocks resident on all of `device`'s SMs at once for the (S, R) plan;
// counted once per device and plan (it depends only on the plan's shared
// memory), then read from the table.  Returns a cudaError_t, 0 on success.
static int resident_blocks(int device, int S, int R, i64* slots) {
  static std::atomic<int> kept[BPM_DEVICES][BPM_MAX][BPM_MAX];
  std::atomic<int>* slot = device >= 0 && device < BPM_DEVICES
                               ? &kept[device][S - 1][R - 1] : nullptr;
  int n = slot ? slot->load(std::memory_order_relaxed) : 0;
  if (n == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gf_bitplane_mma_kernel, BPM_THREADS, smem_bytes(S, R));
    if (err != cudaSuccess) return (int)err;
    n = sms * (per_sm > 0 ? per_sm : 1);
    if (slot) slot->store(n, std::memory_order_relaxed);
  }
  *slots = n;
  return 0;
}

// in: (S, B) uint8 rows of stride in_stride; out: (R, B) uint8 rows of
// stride out_stride; tiles_b: the plan's B operand tiles (rs_bitplane.
// operand_tiles), 16-byte aligned; device pointers on CUDA device
// `device`.  Launches on `stream` and returns the launch's cudaError_t (0
// on success); B == 0 launches nothing.  This library links its own CUDA
// runtime, whose current device is per thread, so it sets the device.
extern "C" int gf_bitplane_mma_launch(const void* in, i64 in_stride,
                                      void* out, i64 out_stride, int S, int R,
                                      i64 B, const void* tiles_b, int device,
                                      void* stream) {
  if (S < 1 || S > BPM_MAX || R < 1 || R > BPM_MAX || B < 0 ||
      (S > 1 && in_stride < B) || (R > 1 && out_stride < B) ||
      ((uintptr_t)tiles_b & 15u))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int bytes = smem_bytes(S, R);  // at most 40 KB: no opt-in needed
  i64 slots = 0;
  const int counted = resident_blocks(device, S, R, &slots);
  if (counted != 0) return counted;
  const i64 tiles = (B + BPM_TILE - 1) / BPM_TILE;
  const unsigned grid = (unsigned)(tiles < slots ? tiles : slots);
  int in_mode = access_mode(in, in_stride);
  int out_mode = access_mode(out, out_stride);
  void* args[] = {&in, &in_stride, &out, &out_stride, &S, &R, &B, &tiles_b,
                  &in_mode, &out_mode};
  err = cudaLaunchKernel((const void*)gf_bitplane_mma_kernel, dim3(grid),
                         dim3(BPM_THREADS), args, bytes,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves its error behind
    return (int)err;
  }
  return (int)cudaGetLastError();
}
#endif  // GF_HOST_TEST
