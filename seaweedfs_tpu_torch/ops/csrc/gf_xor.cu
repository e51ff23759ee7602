// GF(2^8) constant-matrix multiply for Hopper (sm_90a) as the XOR network
// of the doubling chain, batched:
//     out[v][i, :] = XOR_j  coef[i][j] * in[v][j, :]      (field 0x11D)
// for V entries of (S, B) uint8 input -> V entries of (R, B) uint8 output,
// R and S up to 16.
//
// Replaces seaweedfs_tpu/ops/rs_jax.py::make_apply_xor (:70), the XLA
// program of `_multiples` (:40) and `_xor_network` (:54): for each source
// row the doubling chain x*2^k (k = 0..7, x*2 = (x << 1) ^ (0x1D if the top
// bit was set)), and each output row the XOR of the multiples its
// coefficients' bits select.  The batched entry is the counterpart of
// `jax.vmap(make_apply_xor(rows))` (parallel/mesh.py:71).  Unlike the TPU
// program, which XLA traces with the matrix baked in, this kernel takes the
// (R, S) coefficients as a kernel argument: a __grid_constant__ struct, so
// they sit in the constant bank and every thread of a warp reads the same
// byte (a broadcast).  One build serves every matrix; no compile per plan.
// The row count is a template parameter (one instantiation per R) so the
// accumulators stay in registers.
//
// Method.  Each thread owns 16 consecutive columns of every row of its
// entry, as four 32-bit words (SWAR: four bytes per word).  For each
// source row j (a rolled loop) it loads its 16 bytes, then walks the
// doubling chain k = 0..7; at step k each output row i whose coefficient
// coef[i][j] has bit k set XORs the current multiple into its accumulator.
// The branch is uniform over the warp (the coefficient is), so no thread
// diverges.  The doubling of four bytes in a word: shift, mask the carry
// bits out, and XOR 0x1D into each byte whose top bit was set.
//
// Bound: the function's, the bytes, (S + R) * B * V over 3.35 TB/s (70 us
// for RS(10,4) parity at 16 MiB per shard); the bit-sliced kernel
// (csrc/gf_bitslice.cu) computes the same function in 4.7 operations a
// byte.  This kernel issues more: per source row and 16 columns 7
// doublings of 4 words (5 each), a test of each of the 8R coefficient
// bits, and 4 XORs per set bit (rs_xor.xor_ops), for RS(10,4) parity 2344
// per 160 input bytes, 14.7 a byte, ~147 us at 16 MiB at the card's
// 32-bit integer rate.  It trades that for needing no build per matrix.
// PERF.md holds its measured time beside the bound.
//
// Access paths (`mode`, uniform over the grid, chosen by the launcher):
// 2 = 16-byte vector loads and stores (every row start, row stride and
// entry stride 16-byte aligned), 1 = 4-byte words, 0 = bytes.  Only a
// thread whose 16 columns end past column B takes the byte path, masked,
// so no path reads or writes past column B.  blockIdx.y selects the entry;
// past 65535 entries each block walks entries y, y + gridDim.y, ...
// Output entries must not overlap (the launcher's caller allocates them).

#ifndef GF_HOST_TEST  // tests compile the kernels with g++, see below
#include <cuda_runtime.h>
#include <stdint.h>
#endif

typedef unsigned int u32;
typedef unsigned char u8;
typedef long long i64;

#define XOR_THREADS 256
#define XOR_CHUNK 16  // columns per thread
#define XOR_MAX 16    // the largest R and S

struct GfCoef {
  u8 c[XOR_MAX * XOR_MAX];  // coef[i][j] at c[i * XOR_MAX + j]
};

// x * 2 in GF(2^8) for each of the four bytes of x
__device__ __forceinline__ u32 gf_double4(u32 x) {
  const u32 hi = (x >> 7) & 0x01010101u;
  return ((x << 1) & 0xFEFEFEFEu) ^ (hi * 0x1Du);
}

__device__ __forceinline__ void load16(u32 (&x)[4], const u8* row, i64 c0,
                                       i64 B, int mode) {
  const bool full = c0 + XOR_CHUNK <= B;
  if (full && mode == 2) {
    const uint4 a = *reinterpret_cast<const uint4*>(row + c0);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    return;
  }
  if (full && mode == 1) {
#pragma unroll
    for (int w = 0; w < 4; ++w)
      x[w] = *reinterpret_cast<const u32*>(row + c0 + 4 * w);
    return;
  }
#pragma unroll
  for (int w = 0; w < 4; ++w) x[w] = 0u;
#pragma unroll
  for (int c = 0; c < XOR_CHUNK; ++c)
    if (full || c0 + c < B) x[c >> 2] |= (u32)row[c0 + c] << (8 * (c & 3));
}

__device__ __forceinline__ void store16(const u32 (&y)[4], u8* row, i64 c0,
                                        i64 B, int mode) {
  const bool full = c0 + XOR_CHUNK <= B;
  if (full && mode == 2) {
    uint4 a;
    a.x = y[0]; a.y = y[1]; a.z = y[2]; a.w = y[3];
    *reinterpret_cast<uint4*>(row + c0) = a;
    return;
  }
  if (full && mode == 1) {
#pragma unroll
    for (int w = 0; w < 4; ++w)
      *reinterpret_cast<u32*>(row + c0 + 4 * w) = y[w];
    return;
  }
#pragma unroll
  for (int c = 0; c < XOR_CHUNK; ++c)
    if (full || c0 + c < B) row[c0 + c] = (u8)(y[c >> 2] >> (8 * (c & 3)));
}

template <int R>
__global__ void __launch_bounds__(XOR_THREADS)
gf_xor_kernel(const u8* __restrict__ in, i64 in_stride, i64 in_bstride,
              u8* __restrict__ out, i64 out_stride, i64 out_bstride, i64 B,
              i64 V, int S, int mode, const __grid_constant__ GfCoef coef) {
  const i64 c0 =
      ((i64)blockIdx.x * XOR_THREADS + (i64)threadIdx.x) * XOR_CHUNK;
  if (c0 >= B) return;
#pragma unroll 1
  for (i64 v = blockIdx.y; v < V; v += gridDim.y) {
    const u8* src = in + v * in_bstride;
    u32 acc[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int w = 0; w < 4; ++w) acc[i][w] = 0u;
#pragma unroll 1
    for (int j = 0; j < S; ++j) {
      u32 x[4];
      load16(x, src + (i64)j * in_stride, c0, B, mode);
      u32 cj[R];
#pragma unroll
      for (int i = 0; i < R; ++i) cj[i] = coef.c[i * XOR_MAX + j];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
#pragma unroll
        for (int i = 0; i < R; ++i)
          if ((cj[i] >> k) & 1u) {
#pragma unroll
            for (int w = 0; w < 4; ++w) acc[i][w] ^= x[w];
          }
        if (k < 7) {
#pragma unroll
          for (int w = 0; w < 4; ++w) x[w] = gf_double4(x[w]);
        }
      }
    }
    u8* dst = out + v * out_bstride;
#pragma unroll
    for (int i = 0; i < R; ++i)
      store16(acc[i], dst + (i64)i * out_stride, c0, B, mode);
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

// the (rows, srcs) row-major matrix `coef` in the kernel's layout
static inline GfCoef pack_coef(int rows, int srcs, const unsigned char* coef) {
  GfCoef c;
  for (int i = 0; i < XOR_MAX * XOR_MAX; ++i) c.c[i] = 0;
  for (int i = 0; i < rows; ++i)
    for (int j = 0; j < srcs; ++j) c.c[i * XOR_MAX + j] = coef[i * srcs + j];
  return c;
}

#ifndef GF_HOST_TEST
static const void* kernel_for_rows(int rows) {
  switch (rows) {
#define XOR_CASE(n) \
  case n:           \
    return (const void*)gf_xor_kernel<n>;
    XOR_CASE(1) XOR_CASE(2) XOR_CASE(3) XOR_CASE(4) XOR_CASE(5) XOR_CASE(6)
    XOR_CASE(7) XOR_CASE(8) XOR_CASE(9) XOR_CASE(10) XOR_CASE(11)
    XOR_CASE(12) XOR_CASE(13) XOR_CASE(14) XOR_CASE(15) XOR_CASE(16)
#undef XOR_CASE
  }
  return nullptr;
}

// coef: the (rows, srcs) matrix, row-major, in host memory.  in/out: device
// pointers on CUDA device `device`; entry v's input row j starts at
// in + v*in_bstride + j*in_stride, its output row i at
// out + v*out_bstride + i*out_stride; B columns each, V entries.  Launches
// on `stream` and returns the launch's cudaError_t (0 on success); B == 0
// or V == 0 launches nothing.  This library links its own CUDA runtime,
// whose current device is per thread, so it sets the device first.
extern "C" int gf_xor_launch(const void* in, i64 in_stride, i64 in_bstride,
                             void* out, i64 out_stride, i64 out_bstride,
                             i64 B, i64 V, int rows, int srcs,
                             const unsigned char* coef, int device,
                             void* stream) {
  if (rows < 1 || rows > XOR_MAX || srcs < 1 || srcs > XOR_MAX || B < 0 ||
      V < 0 || in_bstride < 0 || (srcs > 1 && in_stride < B) ||
      (rows > 1 && out_stride < B) ||
      (V > 1 && out_bstride < (rows - 1) * out_stride + B))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || V == 0) return 0;
  const i64 per_block = (i64)XOR_THREADS * XOR_CHUNK;
  const i64 blocks = (B + per_block - 1) / per_block;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  GfCoef c = pack_coef(rows, srcs, coef);
  int mode = access_mode(in, in_stride, in_bstride, out, out_stride,
                         out_bstride);
  int s = srcs;
  const dim3 grid((unsigned)blocks, (unsigned)(V < 65535 ? V : 65535));
  void* args[] = {&in, &in_stride, &in_bstride, &out, &out_stride,
                  &out_bstride, &B, &V, &s, &mode, &c};
  const cudaError_t err =
      cudaLaunchKernel(kernel_for_rows(rows), grid, dim3(XOR_THREADS), args,
                       0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
#endif  // GF_HOST_TEST
