// K11 gemm_fp8_mx: the MXFP8 block-scaled GEMM,
//   C[m, n] = bf16( float(sum_k dq(a)[m, k] * dq(b)[n, k]) * alpha ),
// dq = e4m3 byte times the e8m0 scale of its 32-group along K, exact in
// bf16.  A is read through strides, so the TN order (a [M, K]) and the NN
// order (a stored [K, M], the wgrad of the QAT backward) share the kernel.
//
// Replaces qutlass_tpu/kernels/gemm.py:_gemm_fp8_kernel (:151-165, run by
// _run_gemm :193 for matmul_mxf8_bf16_tn/_nn :274-290).
//
// What bounds it on the H100: the bound is the fp8 tensor-core rate, but
// Hopper has no block-scaled MMA and its fp8 and bf16 MMAs sum in fp32
// with truncation, so a cancelling output moves by several bf16 ulps.
// This kernel is exact instead: the operands are decoded to bf16 in
// shared memory (exact), widened to fp64, and multiplied on the fp64
// tensor cores (mma.sync.m8n8k4.f64), whose products are exact and whose
// sums round at 2^-53, so the result is the fp64 plain version's
// (ops/emulation.py:matmul_mxf8_bf16_tn) for every operand the
// quantizers emit.  Its time is set by the decode and the fp64 rate.
// Design: 64x64 output tiles, four warps of 32x32; K advances one
// 32-group at a time, the group's e4m3 and scale bytes loaded into
// registers while the previous group is multiplied.
#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int THREADS = 128;
constexpr int SSTRIDE = BK + 8;  // bf16 per shared row: conflict-free fragment reads

// d[8x8] += a[8x4] b[4x8] in fp64: lane l holds a[l/4][l%4], b[l%4][l/4]
// and d[l/4][2(l%4) + {0, 1}]
__device__ __forceinline__ void mma_f64(double (&d)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// One [64 rows, 32 k] tile of a logical [R, K] e4m3 operand with strides
// (s_r, s_k) and its e8m0 scales [R, K/32] with strides (f_r, f_g).  Each
// thread holds 16 bytes: 16 consecutive k of one row when k is the
// unit-stride axis, else 16 consecutive rows at one k.  Rows past R load
// as zero.  VEC: one 16-byte load (the host checks alignment).
template <bool VEC>
struct Fp8Loader {
  const uint8_t* g;
  long long s_r, s_k;
  const uint8_t* f;
  long long f_r, f_g;
  int R;
  bool r_fast;
  uint32_t d[4];  // 16 bytes, byte j in bits 8*(j%4) of d[j/4]
  uint8_t s[16];  // the scale byte of each (one per row)

  __device__ __forceinline__ int byte(int j) const { return (d[j >> 2] >> (8 * (j & 3))) & 0xFF; }

  __device__ __forceinline__ void coords(int tid, int& rr, int& kk) const {
    if (r_fast) { rr = (tid & 3) * 16; kk = tid >> 2; }
    else { rr = tid >> 1; kk = (tid & 1) * 16; }
  }

  __device__ __forceinline__ void load(int r0, int k0, int tid) {
    int rr, kk;
    coords(tid, rr, kk);
    const int r = r0 + rr, kg = k0 + kk, grp = k0 / BK;
    if (VEC) {
      const bool in = r < R;  // r_fast: R % 16 == 0, so all 16 rows or none
      const uint4 v = in ? *reinterpret_cast<const uint4*>(g + (long long)r * s_r + (long long)kg * s_k)
                         : make_uint4(0, 0, 0, 0);
      d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
    } else {
#pragma unroll
      for (int w = 0; w < 4; ++w) d[w] = 0;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int rj = r_fast ? r + j : r, kj = r_fast ? kg : kg + j;
        if (rj < R) d[j >> 2] |= (uint32_t)g[(long long)rj * s_r + (long long)kj * s_k] << (8 * (j & 3));
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int rj = r_fast ? r + j : r;
      s[j] = (r_fast || j == 0) ? (rj < R ? f[(long long)rj * f_r + (long long)grp * f_g] : (uint8_t)127)
                                : s[0];
    }
  }

  __device__ __forceinline__ void store(__nv_bfloat16 (*t)[SSTRIDE], int tid) const {
    int rr, kk;
    coords(tid, rr, kk);
    if (!r_fast) {
      uint32_t w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        w[j] = qt::e4m3_scaled_bf16_bits(byte(2 * j), s[0]) |
               (qt::e4m3_scaled_bf16_bits(byte(2 * j + 1), s[0]) << 16);
      uint4* dst = reinterpret_cast<uint4*>(&t[rr][kk]);
      dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
      dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        t[rr + j][kk] = __ushort_as_bfloat16((unsigned short)qt::e4m3_scaled_bf16_bits(byte(j), s[j]));
    }
  }
};

template <bool VEC_A, bool VEC_B>
__global__ void __launch_bounds__(THREADS)
gemm_fp8_mx_kernel(const uint8_t* __restrict__ a, long long a_sm, long long a_sk,
                   const uint8_t* __restrict__ af, long long af_r, long long af_g,
                   const uint8_t* __restrict__ b, long long b_sn, long long b_sk,
                   const uint8_t* __restrict__ bf, long long bf_r, long long bf_g,
                   const float* __restrict__ alpha, __nv_bfloat16* __restrict__ c, int M, int N,
                   int K) {
  __shared__ __align__(16) __nv_bfloat16 As[BM][SSTRIDE];
  __shared__ __align__(16) __nv_bfloat16 Bs[BN][SSTRIDE];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  double acc[4][4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = 0.0;

  Fp8Loader<VEC_A> la{a, a_sm, a_sk, af, af_r, af_g, M, a_sk != 1};
  Fp8Loader<VEC_B> lb{b, b_sn, b_sk, bf, bf_r, bf_g, N, b_sk != 1};
  la.load(m0, 0, tid);
  lb.load(n0, 0, tid);
  for (int k0 = 0; k0 < K; k0 += BK) {
    la.store(As, tid);
    lb.store(Bs, tid);
    __syncthreads();
    if (k0 + BK < K) {  // the next group's bytes in flight during this group's MMAs
      la.load(m0, k0 + BK, tid);
      lb.load(n0, k0 + BK, tid);
    }
#pragma unroll
    for (int ks = 0; ks < BK; ks += 4) {
      double af4[4], bf4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) af4[i] = (double)__bfloat162float(As[wm + i * 8 + g][ks + t]);
#pragma unroll
      for (int j = 0; j < 4; ++j) bf4[j] = (double)__bfloat162float(Bs[wn + j * 8 + g][ks + t]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_f64(acc[i][j], af4[i], bf4[j]);
    }
    __syncthreads();
  }

  const float al = *alpha;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + wm + i * 8 + g;
        const int n = n0 + wn + j * 8 + t * 2 + e;
        if (m < M && n < N)
          c[(long long)m * N + n] = __float2bfloat16_rn(__fmul_rn(__double2float_rn(acc[i][j][e]), al));
      }
}

// 16-byte loads need a 16-byte aligned base and, along the unit-stride
// axis, 16-byte steps: k unit-stride with a row stride that is a multiple
// of 16, or rows unit-stride with a k stride that is a multiple of 16 and
// R a multiple of 16
bool vec_ok(const void* p, long long s_r, long long s_k, int R) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  if (s_k == 1) return s_r % 16 == 0;
  if (s_r == 1) return s_k % 16 == 0 && R % 16 == 0;
  return false;
}

}  // namespace

// a: logical [M, K] e4m3 bytes with strides (a_sm, a_sk); b: logical
// [N, K] with strides (b_sn, b_sk); scales: logical [rows, K/32] with
// strides; alpha: one fp32 in device memory; c: bf16 [M, N]; K % 32 == 0.
extern "C" int qt_gemm_fp8_mx(const void* a, long long a_sm, long long a_sk, const void* af,
                              long long af_r, long long af_g, const void* b, long long b_sn,
                              long long b_sk, const void* bf, long long bf_r, long long bf_g,
                              const void* alpha, void* c, int M, int N, int K, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const bool va = vec_ok(a, a_sm, a_sk, M), vb = vec_ok(b, b_sn, b_sk, N);
  auto kernel = va ? (vb ? gemm_fp8_mx_kernel<true, true> : gemm_fp8_mx_kernel<true, false>)
                   : (vb ? gemm_fp8_mx_kernel<false, true> : gemm_fp8_mx_kernel<false, false>);
  kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)a, a_sm, a_sk, (const uint8_t*)af, af_r, af_g, (const uint8_t*)b, b_sn, b_sk,
      (const uint8_t*)bf, bf_r, bf_g, (const float*)alpha, (__nv_bfloat16*)c, M, N, K);
  return (int)cudaGetLastError();
}
