// GF(2^8) constant-matrix multiply for Hopper (sm_90a), batched, as a
// bit-sliced XOR network built for ONE matrix:
//     out[v][i, :] = XOR_j  coef[i][j] * in[v][j, :]      (field 0x11D)
// for V entries of (S, B) uint8 input -> V entries of (R, B) uint8 output.
//
// This file is a template.  ops/gf_network.py defines GF_ROWS and GF_SRCS
// ahead of it and puts the matrix's XOR block in place of the marker line
// in the source loop's switch; ops/_build.py compiles the result with NVRTC
// at the matrix's first use, keyed by the hash of template, block and
// flags; ops/csrc/gf_launch.cu loads and launches it.  It has no includes,
// so NVRTC needs no headers.
//
// Replaces two TPU kernels:
//   * seaweedfs_tpu/ops/rs_pallas.py::_kernel_body (the Pallas SWAR kernel
//     behind make_apply_pallas): the V = 1 case;
//   * bench.py::_tpu_pallas_rate (pallas_call at bench.py:104), the same
//     body on a (K, G) grid over shifted windows: V entries whose input
//     strides overlap.  The codec service stacks (V, S, W) jobs the same way.
// Like the TPU kernel, which unrolls its `rows` tuple when it is traced and
// is compiled once per matrix, this kernel has no run-time coefficients.
//
// Method.  The product is linear over GF(2): output bit k of row i is the
// XOR of the input bits (j, l) where bit_matrix[8i+k][8j+l] is 1.  Each
// thread owns 32 columns of every row of its entry: bytes [16t, 16t+16) and
// [4096+16t, 4096+16t+16) of its block's 8192-column tile, so each warp's
// loads are 512 contiguous bytes.  For each source row (a rolled loop: the
// next row's load is issued before this row's work), the 8 words are
// transposed in registers into 8 bit-planes (transpose8: an 8x8 bit
// transpose of each byte lane across the words, three delta-swap rounds),
// and the generated `case j:` XORs them into the 8R output planes held in
// registers; nvcc fuses `acc ^= a ^ b` into one LOP3.  Then each output
// row's 8 planes are transposed back (transpose8 is an involution) and
// stored.  The doubling chain of the SWAR design is folded into the
// constant network.
//
// Bound: memory.  Each input byte is read once and each output byte written
// once: (S + R) * B * V bytes over 3.35 TB/s, 70 us for RS(10,4) parity at
// 16 MiB per shard.  The ALU work is 60 operations per transpose (S in and
// R out per group) plus the LOP3s of the network: 1511 per 320 input bytes
// for RS(10,4) parity (gf_network.network_ops), ~47 us at 16 MiB at the
// card's 32-bit integer rate (64 per clock per SM): under the memory time.
// The loads go straight to registers, one source row ahead.  A ring of 3-5
// shared-memory stages fed by cp.async.bulk in a persistent grid was tried
// on the H100 and was no faster (PERF.md): at 64 registers, 4 blocks per
// SM keep enough bytes in flight without it.
//
// Access paths (`mode`, uniform over the grid, chosen by the launcher):
// 2 = 16-byte vector loads and stores (every row start, row stride and
// entry stride 16-byte aligned), 1 = 4-byte words, 0 = bytes.  Only the
// last block of a row (its tile ends past column B) masks per byte, so no
// path reads or writes past column B.  blockIdx.y selects the entry; past
// 65535 entries each block walks entries y, y + gridDim.y, ...  Blocks run
// in no order, so entries' outputs must not overlap (the launcher refuses).

typedef unsigned int u32;
typedef unsigned char u8;
typedef long long i64;

#define GF_THREADS 256
#define GF_HALF (16 * GF_THREADS)  // bytes between a thread's two halves
#define GF_TILE (2 * GF_HALF)      // columns per block

// column of byte c (0..31) of the thread whose first byte is at `lo`
__device__ __forceinline__ i64 col_of(int c, i64 lo) {
  return lo + (c & 15) + (c >> 4) * GF_HALF;
}

__device__ __forceinline__ void load32(u32 (&x)[8], const u8* row, i64 lo,
                                       i64 B, bool full, int mode) {
  if (full && mode == 2) {
    const uint4 a = *reinterpret_cast<const uint4*>(row + lo);
    const uint4 b = *reinterpret_cast<const uint4*>(row + lo + GF_HALF);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
    return;
  }
  if (full && mode == 1) {
#pragma unroll
    for (int w = 0; w < 8; ++w)
      x[w] = *reinterpret_cast<const u32*>(row + col_of(4 * w, lo));
    return;
  }
#pragma unroll
  for (int w = 0; w < 8; ++w) x[w] = 0u;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const i64 col = col_of(c, lo);
    if (full || col < B) x[c >> 2] |= (u32)row[col] << (8 * (c & 3));
  }
}

__device__ __forceinline__ void store32(const u32 (&y)[8], u8* row, i64 lo,
                                        i64 B, bool full, int mode) {
  if (full && mode == 2) {
    uint4 a, b;
    a.x = y[0]; a.y = y[1]; a.z = y[2]; a.w = y[3];
    b.x = y[4]; b.y = y[5]; b.z = y[6]; b.w = y[7];
    *reinterpret_cast<uint4*>(row + lo) = a;
    *reinterpret_cast<uint4*>(row + lo + GF_HALF) = b;
    return;
  }
  if (full && mode == 1) {
#pragma unroll
    for (int w = 0; w < 8; ++w)
      *reinterpret_cast<u32*>(row + col_of(4 * w, lo)) = y[w];
    return;
  }
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const i64 col = col_of(c, lo);
    if (full || col < B) row[col] = (u8)(y[c >> 2] >> (8 * (c & 3)));
  }
}

// swaps bit l+d of a with bit l of b, for every l whose bit d is clear
// (m selects those l in each byte)
__device__ __forceinline__ void delta_swap(u32& a, u32& b, int d, u32 m) {
  const u32 t = ((a >> d) ^ b) & m;
  b ^= t;
  a ^= t << d;
}

// 8x8 bit transpose of each byte lane q across the 8 words: afterwards bit
// w of byte q of x[l] is what bit l of byte q of x[w] was.  An involution.
__device__ __forceinline__ void transpose8(u32 (&x)[8]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) delta_swap(x[a], x[a + 4], 4, 0x0F0F0F0Fu);
#pragma unroll
  for (int a = 0; a < 8; ++a)
    if (!(a & 2)) delta_swap(x[a], x[a + 2], 2, 0x33333333u);
#pragma unroll
  for (int a = 0; a < 8; a += 2) delta_swap(x[a], x[a + 1], 1, 0x55555555u);
}

extern "C" __global__ void __launch_bounds__(GF_THREADS)
gf_bitslice(const u8* __restrict__ in, i64 in_stride, i64 in_bstride,
            u8* __restrict__ out, i64 out_stride, i64 out_bstride, i64 B,
            i64 V, int mode) {
  const i64 base = (i64)blockIdx.x * GF_TILE;
  const i64 lo = base + 16 * (i64)threadIdx.x;
  if (lo >= B) return;
  const bool full = base + GF_TILE <= B;

#pragma unroll 1
  for (i64 v = blockIdx.y; v < V; v += gridDim.y) {
    const u8* src = in + v * in_bstride;
    u32 acc[8 * GF_ROWS];
#pragma unroll
    for (int o = 0; o < 8 * GF_ROWS; ++o) acc[o] = 0u;

    u32 next[8];
    load32(next, src, lo, B, full, mode);
#pragma unroll 1
    for (int j = 0; j < GF_SRCS; ++j) {
      u32 p[8];
#pragma unroll
      for (int w = 0; w < 8; ++w) p[w] = next[w];
      if (j + 1 < GF_SRCS)
        load32(next, src + (j + 1) * in_stride, lo, B, full, mode);
      transpose8(p);
      switch (j) {
// @network@
      }
    }

    u8* dst = out + v * out_bstride;
#pragma unroll
    for (int i = 0; i < GF_ROWS; ++i) {
      u32 y[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) y[k] = acc[8 * i + k];
      transpose8(y);
      store32(y, dst + i * out_stride, lo, B, full, mode);
    }
  }
}
