// Native byte-path of seaweedfs_tpu_torch: hardware CRC32C and a SIMD
// GF(2^8) codec, the port's own copy of seaweedfs_tpu/native/seaweed_native.cc.
// It plays the role the reference delegates to SIMD assembly (klauspost/crc32
// for needle checksums, klauspost/reedsolomon for the RS(10,4) hot loop): the
// host-side fast path for per-needle work, where a launch on the card would
// dominate the latency, and the port's `cpu` codec.  Bulk encode and rebuild
// run on the card.
//
// Build: g++ -O3 -shared -fPIC (see build.py).  x86 SIMD paths are guarded so
// the file also compiles on other architectures.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <initializer_list>

#if defined(__SSE4_2__)
#include <nmmintrin.h>
#endif
#if defined(__SSSE3__)
#include <tmmintrin.h>
#endif
#if defined(__GFNI__) && defined(__AVX512F__) && defined(__AVX512BW__)
#define SW_HAVE_GFNI 1
#include <immintrin.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli).  Unmasked; callers apply the LevelDB-style mask.
// ---------------------------------------------------------------------------

static uint32_t crc32c_table[8][256];
static bool crc32c_init_done = false;

static void crc32c_init() {
  if (crc32c_init_done) return;
  const uint32_t poly = 0x82F63B78u;
  for (int i = 0; i < 256; i++) {
    uint32_t crc = (uint32_t)i;
    for (int j = 0; j < 8; j++) crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
    crc32c_table[0][i] = crc;
  }
  for (int k = 1; k < 8; k++)
    for (int i = 0; i < 256; i++)
      crc32c_table[k][i] =
          (crc32c_table[k - 1][i] >> 8) ^ crc32c_table[0][crc32c_table[k - 1][i] & 0xFF];
  crc32c_init_done = true;
}

uint32_t sw_crc32c_update(uint32_t crc, const uint8_t* data, size_t n) {
  crc = ~crc;
#if defined(__SSE4_2__)
  while (n >= 8) {
    uint64_t chunk;
    memcpy(&chunk, data, 8);
    crc = (uint32_t)_mm_crc32_u64(crc, chunk);
    data += 8;
    n -= 8;
  }
  while (n--) crc = _mm_crc32_u8(crc, *data++);
#else
  crc32c_init();
  while (n >= 8) {
    uint32_t low = crc ^ ((uint32_t)data[0] | (uint32_t)data[1] << 8 |
                          (uint32_t)data[2] << 16 | (uint32_t)data[3] << 24);
    crc = crc32c_table[7][low & 0xFF] ^ crc32c_table[6][(low >> 8) & 0xFF] ^
          crc32c_table[5][(low >> 16) & 0xFF] ^ crc32c_table[4][(low >> 24) & 0xFF] ^
          crc32c_table[3][data[4]] ^ crc32c_table[2][data[5]] ^
          crc32c_table[1][data[6]] ^ crc32c_table[0][data[7]];
    data += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ crc32c_table[0][(crc ^ *data++) & 0xFF];
#endif
  return ~crc;
}

// ---------------------------------------------------------------------------
// GF(2^8) codec, field polynomial 0x11D.  outputs[r] = XOR_s M[r][s]*in[s].
// Per-constant low/high-nibble tables; SSSE3 pshufb path processes 16 bytes
// per step (the same trick the reference's SIMD assembly uses).
// ---------------------------------------------------------------------------

static uint8_t gf_mul_table[256][256];
static bool gf_init_done = false;

static void gf_init() {
  if (gf_init_done) return;
  uint8_t exp_t[512];
  int log_t[256];
  int x = 1;
  for (int i = 0; i < 255; i++) {
    exp_t[i] = (uint8_t)x;
    log_t[x] = i;
    x <<= 1;
    if (x & 0x100) x ^= 0x11D;
  }
  for (int i = 255; i < 512; i++) exp_t[i] = exp_t[i - 255];
  for (int a = 0; a < 256; a++)
    for (int b = 0; b < 256; b++)
      gf_mul_table[a][b] =
          (a == 0 || b == 0) ? 0 : exp_t[log_t[a] + log_t[b]];
  gf_init_done = true;
}

static void gf_mul_acc_scalar(uint8_t c, const uint8_t* in, uint8_t* out,
                              size_t n, bool first) {
  const uint8_t* row = gf_mul_table[c];
  if (first) {
    for (size_t i = 0; i < n; i++) out[i] = row[in[i]];
  } else {
    for (size_t i = 0; i < n; i++) out[i] ^= row[in[i]];
  }
}

#if defined(__SSSE3__)
static void gf_mul_acc_ssse3(uint8_t c, const uint8_t* in, uint8_t* out,
                             size_t n, bool first) {
  // Build 16-entry nibble tables for constant c.
  alignas(16) uint8_t lo_tbl[16], hi_tbl[16];
  for (int i = 0; i < 16; i++) {
    lo_tbl[i] = gf_mul_table[c][i];
    hi_tbl[i] = gf_mul_table[c][i << 4];
  }
  __m128i lo = _mm_load_si128((const __m128i*)lo_tbl);
  __m128i hi = _mm_load_si128((const __m128i*)hi_tbl);
  __m128i mask = _mm_set1_epi8(0x0F);
  size_t i = 0;
  for (; i + 16 <= n; i += 16) {
    __m128i v = _mm_loadu_si128((const __m128i*)(in + i));
    __m128i vl = _mm_and_si128(v, mask);
    __m128i vh = _mm_and_si128(_mm_srli_epi64(v, 4), mask);
    __m128i r = _mm_xor_si128(_mm_shuffle_epi8(lo, vl), _mm_shuffle_epi8(hi, vh));
    if (!first) r = _mm_xor_si128(r, _mm_loadu_si128((const __m128i*)(out + i)));
    _mm_storeu_si128((__m128i*)(out + i), r);
  }
  if (i < n) gf_mul_acc_scalar(c, in + i, out + i, n - i, first);
}
#endif

#if defined(SW_HAVE_GFNI)
// GFNI path: multiply-by-constant in ANY GF(2^8) representation is a
// GF(2)-linear map on the byte's bits, so it is one vgf2p8affineqb with a
// per-constant 8x8 bit matrix — 64 bytes per instruction under AVX512,
// no table lookups.  (The same technique modern klauspost/reedsolomon
// and ISA-L use; the reference pins v1.9.2, which predates it.)
static uint64_t gf_affine_matrix[256];
static int gfni_state = 0;  // 0 = untested, 1 = ok, -1 = unusable

static uint64_t gf_build_affine(uint8_t c) {
  // out_bit_i = parity(A.byte[7-i] & x); want out = c*x, so byte (7-i)
  // collects bit i of c*2^j across the basis j.
  uint64_t a = 0;
  for (int i = 0; i < 8; i++) {
    uint8_t rowbyte = 0;
    for (int j = 0; j < 8; j++) {
      if ((gf_mul_table[c][(uint8_t)(1u << j)] >> i) & 1) rowbyte |= (uint8_t)(1u << j);
    }
    a |= (uint64_t)rowbyte << (8 * (7 - i));
  }
  return a;
}

static void gfni_init() {
  if (gfni_state != 0) return;
  // the .so may have been built on a GFNI host and copied to one
  // without it: gate at RUNTIME before executing any AVX512 instruction
  if (!__builtin_cpu_supports("gfni") ||
      !__builtin_cpu_supports("avx512f") ||
      !__builtin_cpu_supports("avx512bw")) {
    gfni_state = -1;
    return;
  }
  for (int c = 0; c < 256; c++) gf_affine_matrix[c] = (uint64_t)gf_build_affine((uint8_t)c);
  // self-check the bit-layout convention against the table codec before
  // trusting it for real data
  alignas(64) uint8_t in[64], out[64];
  for (int i = 0; i < 64; i++) in[i] = (uint8_t)(i * 7 + 3);
  for (int c : {2, 29, 71, 142, 255}) {
    __m512i A = _mm512_set1_epi64((long long)gf_affine_matrix[c]);
    __m512i v = _mm512_loadu_si512((const void*)in);
    _mm512_storeu_si512((void*)out, _mm512_gf2p8affine_epi64_epi8(v, A, 0));
    for (int i = 0; i < 64; i++) {
      if (out[i] != gf_mul_table[c][in[i]]) { gfni_state = -1; return; }
    }
  }
  gfni_state = 1;
}

static void gf_mul_acc_gfni(uint8_t c, const uint8_t* in, uint8_t* out,
                            size_t n, bool first) {
  __m512i A = _mm512_set1_epi64((long long)gf_affine_matrix[c]);
  size_t i = 0;
  for (; i + 64 <= n; i += 64) {
    __m512i v = _mm512_loadu_si512((const void*)(in + i));
    __m512i r = _mm512_gf2p8affine_epi64_epi8(v, A, 0);
    if (!first)
      r = _mm512_xor_si512(r, _mm512_loadu_si512((const void*)(out + i)));
    _mm512_storeu_si512((void*)(out + i), r);
  }
  if (i < n) gf_mul_acc_scalar(c, in + i, out + i, n - i, first);
}
#endif

#if defined(SW_HAVE_GFNI)
// Column-interleaved GFNI kernel: each 64-byte column position loads the s
// input vectors ONCE and keeps all r accumulators in zmm registers, so the
// DRAM traffic is (s + r) streams over n — the row-at-a-time loop below
// makes r*s passes (≈100n bytes of traffic for RS(10,4)), which caps the
// whole codec at ~2 GB/s memory-bound regardless of how fast the
// per-element GF math is.  r is capped at 14 (RS total shards) to bound
// register/stack pressure; anything wider falls back to the row loop.
static void gf_apply_interleaved_gfni(const uint8_t* matrix, int r, int s,
                                      const uint8_t** inputs,
                                      uint8_t** outputs, size_t n) {
  __m512i A[14 * 14];  // affine matrix operands, indexed [i*s + j]
  for (int i = 0; i < r; i++)
    for (int j = 0; j < s; j++)
      A[i * s + j] =
          _mm512_set1_epi64((long long)gf_affine_matrix[matrix[i * s + j]]);
  size_t pos = 0;
  for (; pos + 64 <= n; pos += 64) {
    __m512i acc[14];
    {
      __m512i v = _mm512_loadu_si512((const void*)(inputs[0] + pos));
      for (int i = 0; i < r; i++)
        acc[i] = _mm512_gf2p8affine_epi64_epi8(v, A[i * s], 0);
    }
    for (int j = 1; j < s; j++) {
      __m512i v = _mm512_loadu_si512((const void*)(inputs[j] + pos));
      for (int i = 0; i < r; i++)
        acc[i] = _mm512_xor_si512(
            acc[i], _mm512_gf2p8affine_epi64_epi8(v, A[i * s + j], 0));
    }
    for (int i = 0; i < r; i++)
      _mm512_storeu_si512((void*)(outputs[i] + pos), acc[i]);
  }
  if (pos < n) {  // tail: the scalar table path, first-row semantics
    for (int i = 0; i < r; i++) {
      bool first = true;
      for (int j = 0; j < s; j++) {
        uint8_t c = matrix[i * s + j];
        if (c == 0) continue;
        gf_mul_acc_scalar(c, inputs[j] + pos, outputs[i] + pos, n - pos,
                          first);
        first = false;
      }
      if (first) memset(outputs[i] + pos, 0, n - pos);
    }
  }
}
#endif

void sw_gf_apply(const uint8_t* matrix, int r, int s, const uint8_t** inputs,
                 uint8_t** outputs, size_t n) {
  gf_init();
#if defined(SW_HAVE_GFNI)
  gfni_init();
  if (gfni_state == 1 && r > 0 && r <= 14 && s > 0 && s <= 14) {
    gf_apply_interleaved_gfni(matrix, r, s, inputs, outputs, n);
    return;
  }
#endif
  for (int i = 0; i < r; i++) {
    bool first = true;
    for (int j = 0; j < s; j++) {
      uint8_t c = matrix[i * s + j];
      if (c == 0) continue;
#if defined(SW_HAVE_GFNI)
      if (gfni_state == 1) {
        gf_mul_acc_gfni(c, inputs[j], outputs[i], n, first);
        first = false;
        continue;
      }
#endif
#if defined(__SSSE3__)
      gf_mul_acc_ssse3(c, inputs[j], outputs[i], n, first);
#else
      gf_mul_acc_scalar(c, inputs[j], outputs[i], n, first);
#endif
      first = false;
    }
    if (first) memset(outputs[i], 0, n);
  }
}

}  // extern "C"

extern "C" int sw_gf_impl() {
  // 3 = column-interleaved GFNI+AVX512, 1 = SSSE3, 0 = scalar
  // (introspection for tests and the loader's stale-build self-heal)
  gf_init();
#if defined(SW_HAVE_GFNI)
  gfni_init();
  if (gfni_state == 1) return 3;
#endif
#if defined(__SSSE3__)
  return 1;
#else
  return 0;
#endif
}
