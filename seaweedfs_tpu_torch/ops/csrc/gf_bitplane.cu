// The two elementwise halves of the bit-plane GF(2^8) matrix apply for
// Hopper (sm_90a); the product between them is an int8 matrix product on
// the tensor cores (torch._int_mm, ops/rs_bitplane.py):
//
//   bit_unpack: (S, B) uint8 -> the (8S, W) int8 bit-planes, plane 8j + l
//     of source row j holding bit l of each byte, columns B..W-1 zero (W
//     pads the product's width to a multiple of 8).  The planes are stored
//     column by column, as a (W, 8S) row-major array: the layout cuBLASLt's
//     int8 product takes for its second operand (a row-major (8S, W)
//     operand is refused with CUBLAS_STATUS_NOT_SUPPORTED on the H100);
//   bit_pack:   (8R, B) int32 partial sums -> (R, B) uint8, output byte i
//     holding bit k = (sum of plane 8i + k) & 1.
//
// Replace the two halves of seaweedfs_tpu/ops/rs_jax.py::make_apply_mxu
// (:81): the unpack at :88-90 and the `& 1` and repack at :97-101, which
// are also parallel/mesh.py's `_bit_unpack` (:138) and `_bit_pack` (:146)
// around `distributed_reconstruct`'s psum (:156).  Over GF(2) the codec is
// linear in bits, so out = pack((bit_matrix(M) @ unpack(in)) & 1), where
// the int32 sums of 0/1 products may be added across devices before the
// `& 1` (XOR is addition mod 2).
//
// Bound: memory.  The unpack reads S*B bytes and writes 8*S*W; the pack
// reads 32*R*B (int32 sums) and writes R*B.  The whole route therefore
// moves ~30x the (S + R) * B bytes of the function it computes (for
// RS(10,4) parity: 80B planes written and read, 128B of sums written and
// read, against 14B): it is here for coverage of the reference's
// formulation, not for speed (csrc/gf_bitslice.cu is the fast codec).
// A block of the unpack stages a tile of 1024 columns of the S rows in
// shared memory and writes the tile's 8S x 1024 output bytes, which are
// contiguous, as consecutive 8-byte stores (an earlier version stored
// each column's 8 bytes from the thread that loaded it: 80-byte strides
// between a warp's stores, 4 % of the bytes bound on the H100, PERF.md).
// Each thread of the pack owns 4 columns of an output row: eight 16-byte
// loads of sums, one 4-byte store.
//
// Access paths, chosen by the launchers from the pointers and strides:
// 4-byte loads where the input rows allow (unpack), 16-byte loads of sums
// and 4-byte stores where the rows allow (pack), else single elements;
// the last tile or thread of a row masks, so nothing is read or written
// past the row's width.  The pack's blockIdx.y selects the output row;
// past 65535 each block walks rows y, y + gridDim.y, ...

#ifndef GF_HOST_TEST  // tests compile the kernels with g++
#include <cuda_runtime.h>
#include <stdint.h>
#endif

typedef unsigned int u32;
typedef unsigned char u8;
typedef signed char i8;
typedef long long i64;

#define BP_THREADS 256
#define UNPACK_TILE 1024                 // columns per block of the unpack
#define UNPACK_PITCH (UNPACK_TILE + 4)   // a tile row in shared memory
#define UNPACK_MAX_S 16
#define PACK_CHUNK 4

typedef unsigned long long u64;

// byte b's 8 planes, one per byte: byte l of the result is bit l of b.
// Per nibble, the product by 1 + 2^7 + 2^14 + 2^21 puts bit l of the
// nibble at bit 8l; the four shifted copies do not overlap, so no carry.
__device__ __forceinline__ u64 spread8(u32 b) {
  const u32 lo = ((b & 0xFu) * 0x00204081u) & 0x01010101u;
  const u32 hi = (((b >> 4) & 0xFu) * 0x00204081u) & 0x01010101u;
  return (u64)lo | ((u64)hi << 32);
}

// The unpack in two steps around one barrier.  Load: the block's tile of
// UNPACK_TILE columns of every source row into shared memory (4-byte
// words where the rows allow: a warp reads 128 contiguous bytes), zero
// past column B.  Store: output row c (column c's planes) is 8S
// contiguous bytes, and the tile's rows are contiguous too, so unit u =
// c*S + j, the 8 planes of byte (j, c), goes to byte 8u of the tile's
// output: consecutive threads store consecutive 8-byte units.  The pitch
// of UNPACK_TILE + 4 puts the S bytes of a column in S banks.
__device__ __forceinline__ void unpack_load(u8 (*tile)[UNPACK_PITCH],
                                            const u8* in, i64 in_stride,
                                            i64 S, i64 B, i64 c0,
                                            int words, int tid) {
  const bool full = c0 + UNPACK_TILE <= B;
  for (i64 j = 0; j < S; ++j) {
    const u8* row = in + j * in_stride + c0;
    if (full && words) {
      for (int w = tid; w < UNPACK_TILE / 4; w += BP_THREADS) {
        const u32 x = *reinterpret_cast<const u32*>(row + 4 * w);
#pragma unroll
        for (int q = 0; q < 4; ++q) tile[j][4 * w + q] = (u8)(x >> (8 * q));
      }
    } else {
      for (int c = tid; c < UNPACK_TILE; c += BP_THREADS)
        tile[j][c] = (full || c0 + c < B) ? row[c] : (u8)0;
    }
  }
}

__device__ __forceinline__ void unpack_store(const u8 (*tile)[UNPACK_PITCH],
                                             i8* out, i64 S, i64 W, i64 c0,
                                             int tid) {
  const i64 cols = W - c0 < UNPACK_TILE ? W - c0 : UNPACK_TILE;
  u64* dst = reinterpret_cast<u64*>(out + 8 * S * c0);
  // u = c*S + j, stepped by BP_THREADS without a division per unit
  const int s = (int)S, dj = BP_THREADS % s, dc = BP_THREADS / s;
  int j = tid % s, c = tid / s;
  for (i64 u = tid; u < cols * S; u += BP_THREADS) {
    dst[u] = spread8(tile[j][c]);
    j += dj;
    c += dc;
    if (j >= s) {
      j -= s;
      ++c;
    }
  }
}

__global__ void __launch_bounds__(BP_THREADS)
bit_unpack_kernel(const u8* __restrict__ in, i64 in_stride,
                  i8* __restrict__ out, i64 S, i64 B, i64 W, int words) {
  __shared__ u8 tile[UNPACK_MAX_S][UNPACK_PITCH];
  const i64 c0 = (i64)blockIdx.x * UNPACK_TILE;
  unpack_load(tile, in, in_stride, S, B, c0, words, threadIdx.x);
  __syncthreads();
  unpack_store(tile, out, S, W, c0, threadIdx.x);
}

__global__ void __launch_bounds__(BP_THREADS)
bit_pack_kernel(const int* __restrict__ in, i64 in_stride,
                u8* __restrict__ out, i64 out_stride, i64 R, i64 B,
                int in_vec, int out_word) {
  const i64 c0 =
      ((i64)blockIdx.x * BP_THREADS + (i64)threadIdx.x) * PACK_CHUNK;
  if (c0 >= B) return;
  const bool full = c0 + PACK_CHUNK <= B;
#pragma unroll 1
  for (i64 i = blockIdx.y; i < R; i += gridDim.y) {
    u32 y = 0u;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int* row = in + (8 * i + k) * in_stride;
      if (full && in_vec) {
        const int4 a = *reinterpret_cast<const int4*>(row + c0);
        y |= ((u32)(a.x & 1) << k) | ((u32)(a.y & 1) << (8 + k)) |
             ((u32)(a.z & 1) << (16 + k)) | ((u32)(a.w & 1) << (24 + k));
      } else {
#pragma unroll
        for (int c = 0; c < PACK_CHUNK; ++c)
          if (full || c0 + c < B)
            y |= (u32)(row[c0 + c] & 1) << (8 * c + k);
      }
    }
    u8* dst = out + i * out_stride;
    if (full && out_word) {
      *reinterpret_cast<u32*>(dst + c0) = y;
    } else {
#pragma unroll
      for (int c = 0; c < PACK_CHUNK; ++c)
        if (full || c0 + c < B) dst[c0 + c] = (u8)(y >> (8 * c));
    }
  }
}

// the unpack's input loads: 4-byte words where the rows allow
static inline int unpack_words(const void* in, i64 in_stride) {
  return (((unsigned long long)(uintptr_t)in |
           (unsigned long long)in_stride) & 3ull) == 0;
}

// the pack's: 16-byte loads of 4 sums where the rows allow (in_stride in
// elements), 4-byte stores where the output rows do
static inline void pack_modes(const void* in, i64 in_stride, const void* out,
                              i64 out_stride, int* in_vec, int* out_word) {
  *in_vec = (((unsigned long long)(uintptr_t)in |
              (unsigned long long)(in_stride * 4)) & 15ull) == 0;
  *out_word = (((unsigned long long)(uintptr_t)out |
                (unsigned long long)out_stride) & 3ull) == 0;
}

#ifndef GF_HOST_TEST
static unsigned grid_y(i64 rows) {
  return (unsigned)(rows < 65535 ? rows : 65535);
}

// in: (S, B) uint8 rows of stride in_stride; out: the (W, 8S) int8
// planes, row-major and 8-byte aligned (W >= B), device pointers on CUDA
// device `device`.  Launches on `stream`; returns the launch's cudaError_t
// (0 on success).
extern "C" int bit_unpack_launch(const void* in, i64 in_stride, void* out,
                                 i64 S, i64 B, i64 W, int device,
                                 void* stream) {
  if (S < 0 || S > UNPACK_MAX_S || B < 0 || W < B ||
      (S > 1 && in_stride < B) || ((uintptr_t)out & 7u))
    return (int)cudaErrorInvalidValue;
  if (S == 0 || W == 0) return 0;
  const i64 blocks = (W + UNPACK_TILE - 1) / UNPACK_TILE;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  int words = unpack_words(in, in_stride);
  void* args[] = {&in, &in_stride, &out, &S, &B, &W, &words};
  const cudaError_t err = cudaLaunchKernel(
      (const void*)bit_unpack_kernel, dim3((unsigned)blocks),
      dim3(BP_THREADS), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// in: (8R, >= B) int32 rows of stride in_stride elements; out: (R, B)
// uint8 rows of stride out_stride >= B.  As bit_unpack_launch otherwise.
extern "C" int bit_pack_launch(const void* in, i64 in_stride, void* out,
                               i64 out_stride, i64 R, i64 B, int device,
                               void* stream) {
  if (R < 0 || B < 0 || in_stride < B || (R > 1 && out_stride < B))
    return (int)cudaErrorInvalidValue;
  if (R == 0 || B == 0) return 0;
  const i64 per_block = (i64)BP_THREADS * PACK_CHUNK;
  const i64 blocks = (B + per_block - 1) / per_block;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  int in_vec, out_word;
  pack_modes(in, in_stride, out, out_stride, &in_vec, &out_word);
  void* args[] = {&in, &in_stride, &out, &out_stride, &R, &B, &in_vec,
                  &out_word};
  const cudaError_t err = cudaLaunchKernel(
      (const void*)bit_pack_kernel, dim3((unsigned)blocks, grid_y(R)),
      dim3(BP_THREADS), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
#endif  // GF_HOST_TEST
