// The 64x64 output tile of the single-kernel linears K16 / K17
// (fused_linear.cu): the slab decoders, the accumulation steps and the
// epilogue (whose `out` K4's and K7's kernels use too).  Both formats
// fold exact group terms into fp64 in ascending k: K16 equals K1 + K4 and
// K17 equals K5 + K7 because K4's and K7's kernels add the same exact
// terms (their prefill kernel, gemm_fp4_prefill.cuh, in the same order).
//
// 256 threads hold 4x4 outputs each: thread (tx, ty) = (tid % 16, tid /
// 16) owns rows ty + 16 i and columns tx + 16 j.  A slab is BK columns of
// K decoded into shared memory as fp32, t[k][row], for both operands.
#pragma once

#include "common.cuh"

namespace qt {
namespace tile {

constexpr int BM = 64, BN = 64;
constexpr int THREADS = 256;
constexpr int PAD = 65;  // slab row stride: conflict-free stores along k and along rows

// decode the [rows r0.., k k0..] slab, BK wide, of a logical [R, K] MXFP4
// operand (codes packed two per byte when `packed`, element 2i in the
// low nibble) into t[k][row] as e2m1 values, and its BK/32 groups' e8m0
// scales s[r * s_r + g * s_g] into ts[g][row] as fp32 2^(byte - 127)
// (exact: byte 0 is the subnormal 2^-127, 255 NaN); zero beyond R and K
template <int BK>
__device__ __forceinline__ void decode_mx(float (*t)[PAD], float (*ts)[BM],
                                          const uint8_t* __restrict__ q, long long q_r,
                                          long long q_k, int packed, const uint8_t* __restrict__ s,
                                          long long s_r, long long s_g, int r0, int R, int k0,
                                          int K, int tid) {
  const bool r_fast = q_r == 1;
#pragma unroll (BK == 32 ? 8 : 4)  // whole for 32-wide slabs, 4 of 32 steps for 128
  for (int j = 0; j < BM * BK / THREADS; ++j) {
    const int i = tid + j * THREADS;
    const int rr = r_fast ? i % BM : i / BK;
    const int kk = r_fast ? i / BM : i % BK;
    const int r = r0 + rr, kg = k0 + kk;
    float v = 0.f;
    if (r < R && kg < K) {
      const int code = packed ? q[(long long)r * q_r + (long long)(kg >> 1) * q_k] >> ((kg & 1) * 4)
                              : q[(long long)r * q_r + (long long)kg * q_k];
      v = e2m1_value(code & 0xF);
    }
    t[kk][rr] = v;
  }
  for (int i = tid; i < BK / 32 * BM; i += THREADS) {
    const int g = i / BM, rr = i % BM, r = r0 + rr, kg = k0 + g * 32;
    ts[g][rr] = (r < R && kg < K) ? e8m0_decode(s[(long long)r * s_r + (long long)(kg >> 5) * s_g])
                                  : 0.f;
  }
}

// decode the [rows r0.., k k0..] slab, BK wide, of a logical [R, K/2]
// packed NVFP4 operand into t[k][row] as e2m1 values, and its BK/16
// groups' e4m3 scales s[r * s_r + g * s_g] into ts[g][row]; zero beyond R
// and K
template <int BK>
__device__ __forceinline__ void decode_nv(float (*t)[PAD], float (*ts)[BM],
                                          const uint8_t* __restrict__ q, long long q_r,
                                          long long q_k, const uint8_t* __restrict__ s,
                                          long long s_r, long long s_g, int r0, int R, int k0,
                                          int K, int tid) {
  const bool r_fast = q_r == 1;
#pragma unroll (BK == 32 ? 8 : 4)  // whole for 32-wide slabs, 4 of 32 steps for 128
  for (int j = 0; j < BM * BK / THREADS; ++j) {
    const int i = tid + j * THREADS;
    const int rr = r_fast ? i % BM : i / BK;
    const int kk = r_fast ? i / BM : i % BK;
    const int r = r0 + rr, kg = k0 + kk;
    float v = 0.f;
    if (r < R && kg < K)
      v = e2m1_value((q[(long long)r * q_r + (long long)(kg >> 1) * q_k] >> ((kg & 1) * 4)) & 0xF);
    t[kk][rr] = v;
  }
  for (int i = tid; i < BK / 16 * BM; i += THREADS) {
    const int g = i / BM, rr = i % BM, r = r0 + rr, kg = k0 + g * 16;
    ts[g][rr] = (r < R && kg < K) ? e4m3_decode(s[(long long)r * s_r + (long long)(kg >> 4) * s_g])
                                  : 0.f;
  }
}

template <typename Acc>
__device__ __forceinline__ void zero(Acc (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
}

// the MX step for 32-group g of the slab: the fp32 sum of its 32 e2m1
// products (multiples of 1/4 up to 1152: exact), times both scales in
// fp64 (powers of two from 2^-127 to 2^127, which fp32 would flush or
// overflow: exact), added into fp64, which stays exact while a row
// pair's group terms span fewer than ~40 binades.  K16 and K4's prefill
// kernel fold these terms in ascending k; the decode kernel
// (gemm_fp4_decode.cuh) adds them in another order
__device__ __forceinline__ void mx_accumulate_group(double (&acc)[4][4], const float (*a)[PAD],
                                                    const float (*b)[PAD], const float (*sa)[BM],
                                                    const float (*sb)[BN], int g, int tx, int ty) {
  float p[4][4];
  zero(p);
#pragma unroll
  for (int kk = g * 32; kk < g * 32 + 32; ++kk) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[kk][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[kk][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[i][j] = fmaf(av[i], bv[j], p[i][j]);  // exact
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const double s = (double)sa[g][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j] += (double)p[i][j] * s * (double)sb[g][tx + 16 * j];  // exact term
  }
}

// the NV step for 16-group g of the slab: the fp32 sum of its 16 e2m1
// products (multiples of 1/4 up to 36: exact), times both e4m3 scales
// (12 + 4 + 4 significant bits: exact), added into fp64, which stays
// exact while a row pair's group terms span fewer than ~40 binades
__device__ __forceinline__ void nv_accumulate_group(double (&acc)[4][4], const float (*a)[PAD],
                                                    const float (*b)[PAD], const float (*sa)[BM],
                                                    const float (*sb)[BN], int g, int tx, int ty) {
  float p[4][4];
  zero(p);
#pragma unroll
  for (int kk = g * 16; kk < g * 16 + 16; ++kk) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[kk][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[kk][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[i][j] = fmaf(av[i], bv[j], p[i][j]);  // exact
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float s = sa[g][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j] += (double)__fmul_rn(__fmul_rn(p[i][j], s), sb[g][tx + 16 * j]);  // exact
  }
}

__device__ __forceinline__ void out(__nv_bfloat16* c, long long i, float y) { c[i] = __float2bfloat16_rn(y); }
__device__ __forceinline__ void out(float* c, long long i, float y) { c[i] = y; }

// c[m, n] = Out(float(acc) * alpha) for the tile's outputs below M and N
// (Out bf16, rounded to nearest even, or fp32): the fp64 sum is rounded
// once to fp32 first
template <typename Out = __nv_bfloat16>
__device__ __forceinline__ void store(Out* __restrict__ c, const double (&acc)[4][4], float alpha,
                                      int m0, int n0, int M, int N, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m < M && n < N) out(c, (long long)m * N + n, __fmul_rn(__double2float_rn(acc[i][j]), alpha));
    }
}

}  // namespace tile
}  // namespace qt
