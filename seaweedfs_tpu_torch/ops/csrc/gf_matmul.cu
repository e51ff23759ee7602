// GF(2^8) constant-matrix multiply for Hopper (sm_90a), batched:
//     out[v][i, :] = XOR_j  coef[i][j] * in[v][j, :]      (field 0x11D)
// for an (R <= 16, S <= 16) coefficient matrix given at run time and V
// entries of (S, B) uint8 input -> V entries of (R, B) uint8 output.  RS(10,4)
// parity is R=4, S=10; a rebuild applies a decode plan with R = 1..4 lost
// shards, S = 10.  V = 1 is the plain matrix apply.
//
// Replaces two TPU kernels with one template:
//   * seaweedfs_tpu/ops/rs_pallas.py::_kernel_body (the Pallas SWAR kernel
//     behind make_apply_pallas) — the V = 1 case, entry gf_matmul;
//   * bench.py::_tpu_pallas_rate (pallas_call at bench.py:104), which runs
//     the same body on a (K, G) grid: K sweeps over input windows shifted by
//     one block each, in one dispatch — entry gf_matmul_batched with a batch
//     stride smaller than a window, so windows overlap.  The codec service
//     uses the same entry for (V, S, W) stacks of independent jobs.
// The TPU kernel packs bytes into (S, 256, 128) uint32 lane tiles because
// Mosaic has no u8 vector shifts; here there is no tiling at all: a grid of
// (column blocks, entries), each thread owning 16 consecutive bytes of
// every row of its entry (one uint4 load per source row), running the SWAR
// doubling chain
//     x*2 = ((x << 1) & 0xFEFEFEFE) ^ (((x >> 7) & 0x01010101) * 0x1D)
// on 4 u32 words in registers, and XOR-accumulating the R outputs, stored
// as uint4.  The chain stops at the highest set bit of each column's
// coefficients.  Which outputs take multiple 2^k of source j is a 16-bit
// mask per (j, k) computed on the host; every thread of the grid tests the
// same mask bit, so the branches are uniform and never diverge.
// blockIdx.y selects the entry; past 65535 entries each block walks entries
// y, y + gridDim.y, ...  Blocks run in no order, so every entry has an
// output of its own (the TPU sweep rewrote one output K times, which is a
// race here): the entry point refuses output strides that overlap.
//
// Bound: memory.  Each input byte is read once and each output byte
// written once: (S + R) * B * V bytes over 3.35 TB/s.  RS(10,4) parity at
// 16 MiB per shard is 235 MB, about 70 us.  Beware: a naive SWAR kernel
// like this one may end up bound by the integer ALU instead — roughly
// 10-15 int ops per input byte before the compiler fuses AND/XOR pairs
// into LOP3 — so its measured time sits above the memory bound.  This is
// the simple, correct first version; a wgmma bit-plane or TMA-fed design
// is later work.
//
// Alignment: the 16-byte path needs every row start (input and output,
// i.e. pointer, row stride and batch stride) 16-byte aligned; the launcher
// falls back to a 4-byte path, and to a byte path for rows at odd addresses
// or odd strides.  The last thread of a row masks the ragged tail with byte
// loads, so no path reads or writes past column B.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 16;
constexpr int kMaxSrcs = 16;
constexpr int kThreads = 256;

struct GfParams {
  uint16_t sel[kMaxSrcs][8];  // bit i set: output i takes 2^k * in[j]
  uint8_t nbits[kMaxSrcs];    // doubling steps source j needs (0 = unused)
  int rows;
  int srcs;
};

__device__ __forceinline__ uint32_t gf_mul2(uint32_t x) {
  const uint32_t hi = (x >> 7) & 0x01010101u;
  return ((x << 1) & 0xFEFEFEFEu) ^ (hi * 0x1Du);
}

// Loads this thread's kBytes of one source row into x, zero-filling past
// column B; `full` rows take one aligned W-word load.
template <int W, bool VEC>
__device__ __forceinline__ void load_row(uint32_t (&x)[W], const uint8_t* src,
                                         bool full, int nb) {
  if (VEC && full) {
    if constexpr (W == 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(src);
      x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    } else {
      x[0] = *reinterpret_cast<const uint32_t*>(src);
    }
    return;
  }
#pragma unroll
  for (int w = 0; w < W; ++w) x[w] = 0u;
#pragma unroll
  for (int b = 0; b < 4 * W; ++b)
    if (b < nb) x[b >> 2] |= (uint32_t)src[b] << (8 * (b & 3));
}

// W: u32 words per thread (4 = 16 bytes, 1 = 4 bytes).  VEC: rows are
// aligned for W-word loads; otherwise every access is a byte access.
// The source loop stays rolled (an unrolled 16-source body is ~100 KB of
// SASS per variant, which thrashes the instruction cache and takes minutes
// to compile); the next source's row is loaded before the current one's
// doubling chain runs, so a load is always in flight.  Register arrays are
// only ever indexed by unrolled constants, so nothing spills to the stack.
template <int MAXR, int W, bool VEC>
__global__ void __launch_bounds__(kThreads)
gf_matmul_kernel(const GfParams p, const uint8_t* __restrict__ in,
                 long long in_stride, long long in_bstride,
                 uint8_t* __restrict__ out, long long out_stride,
                 long long out_bstride, long long B, long long V) {
  constexpr int kBytes = 4 * W;
  const long long col =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kBytes;
  if (col >= B) return;
  const bool full = VEC && col + kBytes <= B;
  const int nb = (int)(B - col < kBytes ? B - col : kBytes);

#pragma unroll 1
  for (long long v = blockIdx.y; v < V; v += gridDim.y) {
    const uint8_t* src = in + v * in_bstride + col;
    uint32_t acc[MAXR][W];
#pragma unroll
    for (int i = 0; i < MAXR; ++i)
#pragma unroll
      for (int w = 0; w < W; ++w) acc[i][w] = 0u;

    uint32_t next[W];
    load_row<W, VEC>(next, src, full, nb);
#pragma unroll 1
    for (int j = 0; j < p.srcs; ++j) {
      uint32_t x[W];
#pragma unroll
      for (int w = 0; w < W; ++w) x[w] = next[w];
      if (j + 1 < p.srcs)
        load_row<W, VEC>(next, src + (j + 1) * in_stride, full, nb);
      const int steps = p.nbits[j];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k >= steps) break;
        if (k > 0) {
#pragma unroll
          for (int w = 0; w < W; ++w) x[w] = gf_mul2(x[w]);
        }
        const unsigned m = p.sel[j][k];
#pragma unroll
        for (int i = 0; i < MAXR; ++i) {
          if (m & (1u << i)) {
#pragma unroll
            for (int w = 0; w < W; ++w) acc[i][w] ^= x[w];
          }
        }
      }
    }

    uint8_t* dst_v = out + v * out_bstride + col;
#pragma unroll
    for (int i = 0; i < MAXR; ++i) {
      if (i >= p.rows) break;
      uint8_t* dst = dst_v + i * out_stride;
      if (full) {
        if constexpr (W == 4) {
          *reinterpret_cast<uint4*>(dst) =
              make_uint4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        } else {
          *reinterpret_cast<uint32_t*>(dst) = acc[i][0];
        }
      } else {
#pragma unroll
        for (int b = 0; b < kBytes; ++b)
          if (b < nb) dst[b] = (uint8_t)(acc[i][b >> 2] >> (8 * (b & 3)));
      }
    }
  }
}

struct Operands {
  const uint8_t* in;
  long long in_stride, in_bstride;
  uint8_t* out;
  long long out_stride, out_bstride;
  long long B, V;
};

template <int MAXR, int W, bool VEC>
cudaError_t launch(const GfParams& p, const Operands& o, cudaStream_t stream) {
  const long long threads = (o.B + 4 * W - 1) / (4 * W);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, (unsigned)(o.V < 65535 ? o.V : 65535));
  gf_matmul_kernel<MAXR, W, VEC><<<grid, kThreads, 0, stream>>>(
      p, o.in, o.in_stride, o.in_bstride, o.out, o.out_stride, o.out_bstride,
      o.B, o.V);
  return cudaGetLastError();
}

template <int MAXR>
cudaError_t dispatch_align(const GfParams& p, const Operands& o,
                           cudaStream_t stream) {
  const unsigned long long align =
      (unsigned long long)(uintptr_t)o.in | (unsigned long long)o.in_stride |
      (unsigned long long)o.in_bstride | (unsigned long long)(uintptr_t)o.out |
      (unsigned long long)o.out_stride | (unsigned long long)o.out_bstride;
  if ((align & 15ull) == 0) return launch<MAXR, 4, true>(p, o, stream);
  if ((align & 3ull) == 0) return launch<MAXR, 1, true>(p, o, stream);
  return launch<MAXR, 1, false>(p, o, stream);
}

}  // namespace

// coef: host pointer to rows*srcs coefficients, row-major.  in/out: device
// pointers on CUDA device `device`; entry v's input row j starts at
// in + v*in_bstride + j*in_stride, its output row i at
// out + v*out_bstride + i*out_stride; B columns each, V entries.  Input
// entries may overlap (a sweep over shifted windows); output rows and
// entries may not.  Launches on `stream` and returns cudaGetLastError() of
// the launch (0 on success); B == 0 or V == 0 launches nothing.
extern "C" int gf_matmul_batched(const uint8_t* coef, int rows, int srcs,
                                 const void* in, long long in_stride,
                                 long long in_bstride, void* out,
                                 long long out_stride, long long out_bstride,
                                 long long B, long long V, int device,
                                 void* stream) {
  if (rows < 1 || rows > kMaxRows || srcs < 1 || srcs > kMaxSrcs || B < 0 ||
      V < 0 || in_bstride < 0 || (srcs > 1 && in_stride < B) ||
      (rows > 1 && out_stride < B) ||
      (V > 1 && out_bstride < (rows - 1) * out_stride + B))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || V == 0) return 0;
  // this library links its own CUDA runtime, whose current device is
  // per thread and independent of PyTorch's
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  GfParams p = {};
  p.rows = rows;
  p.srcs = srcs;
  for (int i = 0; i < rows; ++i) {
    for (int j = 0; j < srcs; ++j) {
      const unsigned c = coef[i * srcs + j];
      for (int k = 0; k < 8; ++k) {
        if ((c >> k) & 1u) {
          p.sel[j][k] |= (uint16_t)(1u << i);
          if (p.nbits[j] < k + 1) p.nbits[j] = (uint8_t)(k + 1);
        }
      }
    }
  }
  const Operands o = {static_cast<const uint8_t*>(in), in_stride, in_bstride,
                      static_cast<uint8_t*>(out), out_stride, out_bstride,
                      B, V};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 4) return (int)dispatch_align<4>(p, o, s);
  if (rows <= 8) return (int)dispatch_align<8>(p, o, s);
  return (int)dispatch_align<16>(p, o, s);
}

// The V = 1 case: one (S, B) input with row stride in_stride -> one (R, B)
// output with row stride out_stride.
extern "C" int gf_matmul(const uint8_t* coef, int rows, int srcs,
                         const void* in, long long in_stride, void* out,
                         long long out_stride, long long B, int device,
                         void* stream) {
  return gf_matmul_batched(coef, rows, srcs, in, in_stride, 0, out,
                           out_stride, 0, B, 1, device, stream);
}
