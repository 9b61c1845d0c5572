// K12 backward_t_bf16 and K13 backward_qt_bf16: the Quartet backward's
// MXFP4 operands quantized along the token axis.  Both rotate a [R, C]
// operand along R in `rot` chunks and quantize the transpose to MXFP4 in
// 32-groups along R with the backward's abs-max rule (no +1e-8): codes u8
// [C, R/2] (element 2i in the low nibble) and e8m0 bytes u8 [C, R/32].
//   K12: x bf16 [R=N, C=K]; byte = pow2floor(amax), q = (v * 2^(127-byte)) * 3.
//   K13: x the MXFP4 operand [R=M, C=N] (packed u8 [M, N/2], e8m0 [M, N/32]),
//        decoded exactly without alpha; byte = pow2floor(amax / alpha),
//        q = v * (3 / (scale * alpha)) (true fp32 divisions).
// A zero or subnormal group gets byte 0 and the scale 2^-127 (the fp64
// golden's); byte 255 (an inf or NaN in the group) the multiplier 0.  The
// plain versions are ops/emulation.py:backward_t_bf16 / backward_qt_bf16.
//
// Replaces qutlass_tpu/kernels/backward.py:_backward_t_kernel
// (backward_t_bf16_2d, :63-113) and _backward_qt_kernel
// (backward_qt_bf16_2d, :120-196).  The TPU kernels rotate on the MXU
// (the K13 one with a 256-wide block diagonal, the same chunks) and
// multiply by 2^(127-byte) from a bit trick; here the reciprocal is formed
// from the byte and every e8m0 byte decodes exactly.
//
// What bounds it on the H100: bytes (K12 reads 2 B and writes ~0.53 B per
// element; K13 ~0.53 B each way) against `rot` fp32 FMAs per element on
// the CUDA cores, which at rot 32 take about as long.  Design: a block
// stages a tile of 128 rows (a multiple of 32 and of every rot) x 32
// columns in bf16 in shared memory, with the rotation; one warp then takes
// one 32-group of one column, lane i holding rotated row i (the sequential
// fmaf order of common.cuh:rotate_elem, transposed), so the group maximum
// is one warp reduction and two lanes' codes pack into one byte by a
// shuffle.
#include "common.cuh"

namespace {

constexpr int TR = 128;      // rows of the rotated (group) axis per block
constexpr int TC = 32;       // columns per block
constexpr int THREADS = 256;

// Code and scale byte of rotated value v in its 32-group, one value per
// lane (QT: the K13 rule with alpha, else the K12 rule).
template <bool QT>
__device__ __forceinline__ int requant(float v, float alpha, int& byte) {
  const bool nan = __any_sync(0xFFFFFFFFu, v != v);  // fmaxf drops NaNs; torch.amax keeps them
  const float amax = nan ? __int_as_float(0x7FC00000) : qt::warp_max(fabsf(v));
  float q;
  if constexpr (!QT) {
    byte = (__float_as_int(amax) & 0x7F800000) >> 23;
    const float r = byte == 255 ? 0.f : qt::e8m0_decode(254 - byte);
    q = __fmul_rn(__fmul_rn(v, r), 3.0f);
  } else {
    byte = (__float_as_int(__fdiv_rn(amax, alpha)) & 0x7F800000) >> 23;
    if (byte == 0) {  // scale 2^-127: v doubled, the multiplier formed at 2^-126
      q = __fmul_rn(__fmul_rn(v, 2.0f), __fdiv_rn(3.0f, __fmul_rn(qt::e8m0_decode(1), alpha)));
    } else {
      const float s = byte == 255 ? __int_as_float(0x7F800000) : qt::e8m0_decode(byte);
      q = __fmul_rn(v, __fdiv_rn(3.0f, __fmul_rn(s, alpha)));
    }
  }
  return qt::e2m1_code(q);
}

// K12 (QT false): x bf16 [batch, R, C] contiguous.  K13 (QT true): xq u8
// [batch, R, C/2] contiguous, sf e8m0 with strides (sf_b, sf_r, sf_g),
// alpha one fp32 in device memory.  q u8 [batch, C, R/2], s u8
// [batch, C, R/32].  R a multiple of 32 and of rot; C any (K12) or a
// multiple of 32 (K13).
template <bool QT>
__global__ void __launch_bounds__(THREADS)
backward_quant_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ xq,
                      const uint8_t* __restrict__ sf, long long sf_b, long long sf_r,
                      long long sf_g, const float* __restrict__ alpha,
                      const __nv_bfloat16* __restrict__ h, uint8_t* __restrict__ q,
                      uint8_t* __restrict__ s, int R, int C, int rot) {
  __shared__ __nv_bfloat16 h_s[128 * 128];
  __shared__ __nv_bfloat16 t_s[TR][TC + 2];  // +2: rows rot apart fall in other banks

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long b = blockIdx.z;
  const int r0 = blockIdx.x * TR, c0 = blockIdx.y * TC;

  for (int i = tid; i < rot * rot; i += THREADS) h_s[i] = h[i];
  if constexpr (!QT) {
    x += b * R * C;
    for (int i = tid; i < TR * TC; i += THREADS) {
      const int rr = i / TC, cc = i % TC, r = r0 + rr, c = c0 + cc;
      t_s[rr][cc] = (r < R && c < C) ? x[(long long)r * C + c] : __float2bfloat16(0.f);
    }
  } else {
    xq += b * R * (C / 2);
    sf += b * sf_b;
    for (int i = tid; i < TR * TC / 2; i += THREADS) {
      const int rr = i / (TC / 2), cp = i % (TC / 2), r = r0 + rr, c = c0 + 2 * cp;
      float v0 = 0.f, v1 = 0.f;
      if (r < R && c < C) {
        const int w = xq[(long long)r * (C / 2) + c / 2];
        const int sb = sf[(long long)r * sf_r + (long long)(c / 32) * sf_g];
        v0 = qt::e2m1_decode_scaled(w & 0xF, sb);
        v1 = qt::e2m1_decode_scaled(w >> 4, sb);
      }
      t_s[rr][2 * cp] = __float2bfloat16_rn(v0);  // exact bf16 values
      t_s[rr][2 * cp + 1] = __float2bfloat16_rn(v1);
    }
  }
  __syncthreads();

  const float al = QT ? *alpha : 0.f;
  const int groups = min(TR, R - r0) / 32, cols = min(TC, C - c0);
  for (int p = warp; p < TC * (TR / 32); p += THREADS / 32) {
    const int g = p / TC, cc = p % TC;
    if (g >= groups || cc >= cols) continue;  // warp-uniform
    const int rr = g * 32 + lane, rc0 = (rr / rot) * rot, hc = rr - rc0;
    float v = 0.f;
    for (int i = 0; i < rot; ++i)
      v = fmaf(__bfloat162float(t_s[rc0 + i][cc]), __bfloat162float(h_s[i * rot + hc]), v);
    int byte;
    const int code = requant<QT>(v, al, byte);
    const int hi = __shfl_down_sync(0xFFFFFFFFu, code, 1);
    const long long col = b * C + c0 + cc;
    if ((lane & 1) == 0) q[col * (R / 2) + (r0 + rr) / 2] = (uint8_t)(code | (hi << 4));
    if (lane == 0) s[col * (R / 32) + r0 / 32 + g] = (uint8_t)byte;
  }
}

dim3 grid_of(int R, int C, int batch) { return dim3((R + TR - 1) / TR, (C + TC - 1) / TC, batch); }

}  // namespace

// K12: x bf16 [batch, R, C] contiguous, h bf16 [rot, rot]; q u8
// [batch, C, R/2], s u8 [batch, C, R/32].
extern "C" int qt_backward_t(const void* x, const void* h, void* q, void* s, int R, int C, int rot,
                             int batch, void* stream) {
  backward_quant_kernel<false><<<grid_of(R, C, batch), THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, nullptr, nullptr, 0, 0, 0, nullptr, (const __nv_bfloat16*)h,
      (uint8_t*)q, (uint8_t*)s, R, C, rot);
  return (int)cudaGetLastError();
}

// K13: xq u8 [batch, R, C/2] contiguous, sf e8m0 [batch, R, C/32] with
// strides (sf_b, sf_r, sf_g), alpha fp32 [1] on the card; outputs as K12.
extern "C" int qt_backward_qt(const void* xq, const void* sf, long long sf_b, long long sf_r,
                              long long sf_g, const void* alpha, const void* h, void* q, void* s,
                              int R, int C, int rot, int batch, void* stream) {
  backward_quant_kernel<true><<<grid_of(R, C, batch), THREADS, 0, (cudaStream_t)stream>>>(
      nullptr, (const uint8_t*)xq, (const uint8_t*)sf, sf_b, sf_r, sf_g, (const float*)alpha,
      (const __nv_bfloat16*)h, (uint8_t*)q, (uint8_t*)s, R, C, rot);
  return (int)cudaGetLastError();
}
