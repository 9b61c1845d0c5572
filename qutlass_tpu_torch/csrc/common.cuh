// Shared device codecs for the MXFP4 and NVFP4 kernels.
//
// Each function is the bit-for-bit CUDA twin of the function of the same
// name in qutlass_tpu_torch/formats/codecs.py.  The scale arithmetic is
// written with __fmul_rn/__fadd_rn/__fsqrt_rn so that no FMA contraction
// or approximate square root can move a value by an ulp (the library is
// also compiled with --fmad=false); powers of two are built from bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qt {

// float32(2.92247856 / 6.0) and float32(1e-8), rounded from the double
// values exactly as PyTorch rounds a Python float against an fp32 tensor.
constexpr float kQuestConst = (float)(2.92247856 / 6.0);
constexpr float kScaleEps = (float)1e-8;

// fp32 -> e2m1 code 0..15: RTNE with even-code ties, saturating to +-6,
// NaN -> +0.  Integer-domain encoder on the fp32 bit pattern.
__device__ __forceinline__ int e2m1_code(float q) {
  const int b = __float_as_int(q);
  const int sign = (b >> 28) & 8;
  int a = b & 0x7FFFFFFF;
  a = a > 0x7F800000 ? 0 : min(a, 0x40C00000);
  const int cl = (a > 0x3E800000) + (a >= 0x3F400000);
  const int r = a + 0x1FFFFF + ((a >> 22) & 1);
  const int code = a < 0x3F800000 ? cl : (r >> 22) - 252;
  return code | sign;
}

// e2m1 code -> signed 2*value (the int8 evaluator's mantissa).
__device__ __forceinline__ int e2m1_m2(int code) {
  const int mag = code & 7;
  const int m = mag < 5 ? mag : (mag < 7 ? 2 * mag - 4 : 12);
  return code >= 8 ? -m : m;
}

// e8m0 byte -> fp32 2^(byte-127); byte 0 -> 2^-127 (subnormal), 255 -> NaN.
__device__ __forceinline__ float e8m0_decode(int byte) {
  if (byte == 255) return __int_as_float(0x7FC00000);
  if (byte == 0) return __int_as_float(0x00400000);
  return __int_as_float(byte << 23);
}

// exact 2^n, n clamped to [-127, 127]
__device__ __forceinline__ float pow2_f32(int n) {
  return e8m0_decode(min(max(n + 127, 0), 254));
}

// e2m1 code times e8m0 scale -> exact bf16 value, returned as fp32.
// Integer-only: the scale is an add on the bf16 exponent field; exponent
// underflow gives the exact subnormal (RTNE on the shifted-out bits),
// overflow saturates to inf, scale byte 255 gives NaN.
__device__ __forceinline__ float e2m1_decode_scaled(int code, int sb) {
  const int mag = code & 7;
  const int e = mag >> 1;
  const int mant = ((code & 1) & min(e, 1)) << 6;
  const int x = e + sb - 1;
  const int norm = (x << 7) | mant;
  const int s = min(max(1 - x, 1), 15);
  const int sig = 0x80 | mant;
  const int shifted = sig >> s;
  const int rem = sig & ((1 << s) - 1);
  const int half = 1 << (s - 1);
  const int subn = shifted + ((rem > half) | ((rem == half) & (shifted & 1)));
  const int hi = x >= 255 ? (255 << 7) : norm;
  int bits = mag == 0 ? 0 : (x > 0 ? hi : subn);
  bits |= (code & 8) << 12;
  if (sb == 255) bits = 0x7FC0;
  return __int_as_float(bits << 16);
}

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: every lane ends with the same, bitwise identical sum
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  return v;
}

// e8m0 scale byte of one 32-group held one element per lane.
// method 0 = QuEST (sqrt(var) * 2.92247856/6 + 1e-8, 1.0 where var < 0),
// method 1 = abs-max (amax + 1e-8); then the pow2 floor by bit masking.
__device__ __forceinline__ int group_scale_byte(float v, int method) {
  float scale;
  if (method == 0) {
    const float s1 = warp_sum(v);
    const float s2 = warp_sum(__fmul_rn(v, v));
    const float mean = __fmul_rn(s1, 0.03125f);
    const float var = __fsub_rn(__fmul_rn(s2, 0.03125f), __fmul_rn(mean, mean));
    scale = var >= 0.f ? __fadd_rn(__fmul_rn(__fsqrt_rn(var), kQuestConst), kScaleEps) : 1.0f;
  } else {
    scale = __fadd_rn(warp_max(fabsf(v)), kScaleEps);
  }
  return (__float_as_int(scale) & 0x7F800000) >> 23;
}

// scaled value to round onto the e2m1 grid: v * 2^(127-byte) (exact
// reciprocal), times 3 for abs-max
__device__ __forceinline__ float group_q(float v, int byte, int method) {
  float q = __fmul_rn(v, e8m0_decode(254 - byte));
  return method == 0 ? q : __fmul_rn(q, 3.0f);
}

// ---------------------------------------------------------------------------
// e4m3 (the NVFP4 block scales)
// ---------------------------------------------------------------------------

// float32(1/6), rounded from the double as PyTorch rounds a Python float
constexpr float kSixth = (float)(1.0 / 6.0);

// |x| (NaN cleared, clamped to 448) -> exact e4m3-rounded magnitude: RTNE
// to 3 mantissa bits on the fp32 bits in the normal range, the 2^-9 grid
// below 2^-6 (codecs._e4m3_round_mag)
__device__ __forceinline__ float e4m3_round_mag(float a) {
  const int bits = __float_as_int(a);
  const int lsb = (bits >> 20) & 1;
  const float rn = fminf(__int_as_float((bits + lsb + 0x7FFFF) & ~0xFFFFF), 448.f);
  const float sub = __fmul_rn(rintf(__fmul_rn(a, 512.f)), 0.001953125f);
  return a < 0.015625f ? sub : rn;
}

// fp32 -> e4m3fn byte: RTNE, saturating to +-448, NaN -> 0x7F with the
// NaN's sign bit (codecs.e4m3_rtne_bytes)
__device__ __forceinline__ int e4m3_byte(float x) {
  const int sign = (__float_as_int(x) >> 31) & 1;
  const bool nan = x != x;
  const float v = e4m3_round_mag(nan ? 0.f : fminf(fabsf(x), 448.f));
  const int vb = __float_as_int(v);
  const int exp32 = (vb >> 23) & 0xFF;
  int byte = exp32 < 121 ? __float2int_rn(__fmul_rn(v, 512.f))
                         : ((exp32 - 120) << 3) | ((vb >> 20) & 7);
  if (v == 0.f) byte = 0;
  if (nan) byte = 0x7F;
  return byte | (sign << 7);
}

// e4m3fn byte -> exact fp32; 0x7F / 0xFF -> NaN (codecs.e4m3_decode_f32)
__device__ __forceinline__ float e4m3_decode(int b) {
  const int e = (b >> 3) & 0xF, m = b & 7;
  float v = e == 0 ? __fmul_rn((float)m, 0.001953125f) : __int_as_float(((e + 120) << 23) | (m << 20));
  if (e == 15 && m == 7) v = __int_as_float(0x7FC00000);
  return (b & 0x80) ? -v : v;
}

// e2m1 code -> exact fp32 value (codecs.e2m1_decode_f32)
__device__ __forceinline__ float e2m1_value(int code) {
  const float m2 = (float)e2m1_m2(code);  // 2 * value, exact
  return __fmul_rn(m2, 0.5f);
}

// sums and maxima over the 16 lanes of a half warp (xor offsets < 16 stay
// in the half): each half of a warp holds one NVFP4 group
__device__ __forceinline__ float half_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  return v;
}

__device__ __forceinline__ float half_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  return v;
}

// output multiplier of an NVFP4 group from its scale byte: abs-max
// (method 1) gs / SF, QuEST (method 0) 1 / scale; 0 where the decoded
// scale is 0 (abs-max), not positive (QuEST) or NaN
// (codecs.nv_absmax_scale_bytes / nv_quest_scale_bytes)
__device__ __forceinline__ float nv_mul(int byte, int method, float gs) {
  const float sq = e4m3_decode(byte);
  if (sq != sq) return 0.f;
  if (method == 1) return sq != 0.f ? __fdiv_rn(gs, sq) : 0.f;
  return sq > 0.f ? __fdiv_rn(1.f, sq) : 0.f;
}

// e4m3 scale byte of the NVFP4 group held by this lane's half warp, one
// element per lane.  method 0 = QuEST: sqrt(var) * 2.92247856/6 + 1e-8,
// and var < 0 gives the sign-set NaN of the reference (byte 0xFF, which
// zeroes the group); method 1 = abs-max: e4m3(gs * (amax * (1/6))).
__device__ __forceinline__ int nv_group_byte(float v, int method, float gs) {
  if (method == 1) return e4m3_byte(__fmul_rn(gs, __fmul_rn(half_max(fabsf(v)), kSixth)));
  const float s1 = half_sum(v);
  const float s2 = half_sum(__fmul_rn(v, v));
  const float mean = __fmul_rn(s1, 0.0625f);
  const float var = __fsub_rn(__fmul_rn(s2, 0.0625f), __fmul_rn(mean, mean));
  if (!(var >= 0.f)) return 0xFF;
  return e4m3_byte(__fadd_rn(__fmul_rn(__fsqrt_rn(var), kQuestConst), kScaleEps));
}

// ---------------------------------------------------------------------------
// MXFP8 (the QAT backward's square-double quantization and fp8 GEMM)
// ---------------------------------------------------------------------------

// shared exponent byte of a tile or group (codecs.mxfp8_shared_exp_bytes):
// floor(log2 amax) - 7 + 127, wrapping mod 256; 127 where amax is 0 or NaN
__device__ __forceinline__ int mxfp8_shared_exp(float amax) {
  if (!(amax > 0.f)) return 127;
  return ((((__float_as_int(amax) & 0x7F800000) >> 23) - 7) & 0xFF);
}

// 1 / 2^(e-127) as the exact power of two 2^(127-e), formed from the byte:
// a multiply by it rounds like the division by the decoded scale, byte 0
// (scale 2^-127, a subnormal) included.  Byte 255 (a NaN scale) gives NaN.
__device__ __forceinline__ float mxfp8_inv_scale(int e) {
  return e == 255 ? __int_as_float(0x7FC00000) : e8m0_decode(254 - e);
}

// fp32 -> nearest bf16 value as fp32; a NaN as the positive NaN
__device__ __forceinline__ float bf16_round(float v) {
  return v != v ? __int_as_float(0x7FC00000) : __bfloat162float(__float2bfloat16_rn(v));
}

// bf16 bits of fp32 v, RTNE; a NaN as 0x7FC0
__device__ __forceinline__ unsigned short bf16_bits(float v) {
  return v != v ? (unsigned short)0x7FC0 : __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// e4m3 byte times e8m0 scale byte -> the exact bf16 bits, integer-only
// (codecs.e4m3_decode_scaled_bf16): subnormal e4m3 values are normalized,
// exponent underflow gives the exact bf16 subnormal (RTNE), overflow inf,
// a NaN byte or scale byte 255 gives 0x7FC0 with the byte's sign.
__device__ __forceinline__ unsigned int e4m3_scaled_bf16_bits(int b, int sb) {
  const int e = (b >> 3) & 0xF, m = b & 7;
  const int t = m > 3 ? 2 : (m > 1 ? 1 : 0);
  const int x = e == 0 ? t + sb - 9 : e + sb - 7;
  const int mant = e == 0 ? (m - (1 << t)) << (7 - t) : m << 4;
  const int s = min(max(1 - x, 1), 15);
  const int sig = 0x80 | mant;
  const int shifted = sig >> s;
  const int rem = sig & ((1 << s) - 1);
  const int half = 1 << (s - 1);
  const int subn = shifted + ((rem > half) | ((rem == half) & (shifted & 1)));
  const int hi = x >= 255 ? (255 << 7) : ((x << 7) | mant);
  int bits = (e == 0 && m == 0) ? 0 : (x > 0 ? hi : subn);
  if ((e == 15 && m == 7) || sb == 255) bits = 0x7FC0;
  return (unsigned int)(bits | ((b & 0x80) << 8));
}

// Rotated element `col` of a 128-wide bf16 tile row held in shared memory:
// sum over the rot-chunk containing col of x[c0 + i] * h[i][col - c0],
// in fp32 (the products of two bf16 values are exact in fp32).
__device__ __forceinline__ float rotate_elem(const __nv_bfloat16* xrow, const __nv_bfloat16* h,
                                             int rot, int col) {
  const int c0 = (col / rot) * rot;
  const int hc = col - c0;
  float v = 0.f;
  for (int i = 0; i < rot; ++i)
    v = fmaf(__bfloat162float(xrow[c0 + i]), __bfloat162float(h[i * rot + hc]), v);
  return v;
}

}  // namespace qt
