// K7 gemm_fp4_nv: the NVFP4 decode GEMM,
//   C[m, n] = out( float(sum_k dq(a)[m, k] * dq(b)[n, k]) * alpha ),
// dq = e2m1 value times its 16-group e4m3 scale; out = bf16 or fp32.
//
// Replaces the Pallas kernel qutlass_tpu/kernels/gemm.py:_run_gemm with
// fmt="nv" (:168), behind matmul_nvf4_bf16_tn and _kmajor (:255/:265):
// the GEMM of NVFP4 linears with fp4-stored weights.
//
// What bounds it on the H100: at decode (M = 4) the weight bytes, 0.56
// byte per weight element; at prefill the CUDA cores' fp32 rate, since
// this first version does not use the tensor cores.
//
// Exactness, and what the design does about it.  An e4m3 scale is not a
// power of two, so the fp32 partial sums of a plain fp32 accumulation
// are not exact: over K = 4096 they would round, and a bf16 result would
// differ from the fp64 reference at a rate near 1e-3.  Instead, per
// 16-group, the kernel sums the unscaled e2m1 products in fp32 (values
// are multiples of 1/4 up to 36, so 16 of them sum exactly), multiplies
// the group sum by the two scales (12 + 4 + 4 significant bits: exact),
// and adds that into an fp64 accumulator, which stays exact while the
// group terms of a row pair span fewer than ~40 binades.  The result,
// rounded once to fp32 and scaled by alpha, is then bitwise the plain
// version's (fp64 sum of exact products, rounded once).
//
// Tiles: 64x64 outputs, 256 threads of 4x4 outputs each (the tile of
// gemm_fp4_tile.cuh, shared with K17).  Every K step
// of 32 (two scale groups) decodes a 32x64 slab of each operand into
// shared memory as fp32 e2m1 values, plus the slab's scales.  Operands
// and scales are read through strides, so the row-major and K-major
// layouts share the kernel.  alpha is read from device memory.
#include "gemm_fp4_tile.cuh"

namespace {

using namespace qt::tile;
constexpr int BK = 32;  // two scale groups

template <typename Out>
__global__ void __launch_bounds__(THREADS)
gemm_fp4_nv_kernel(const uint8_t* __restrict__ a, long long a_m, long long a_k,
                   const uint8_t* __restrict__ as, long long as_m, long long as_g,
                   const uint8_t* __restrict__ b, long long b_n, long long b_k,
                   const uint8_t* __restrict__ bs, long long bs_n, long long bs_g,
                   const float* __restrict__ alpha_ptr, Out* __restrict__ c, int M, int N, int K) {
  __shared__ float As[BK][PAD];
  __shared__ float Bs[BK][PAD];
  __shared__ float Sa[BK / 16][BM];
  __shared__ float Sb[BK / 16][BN];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  double acc[4][4];
  zero(acc);
  for (int k0 = 0; k0 < K; k0 += BK) {
    decode_nv<BK>(As, Sa, a, a_m, a_k, as, as_m, as_g, m0, M, k0, K, tid);
    decode_nv<BK>(Bs, Sb, b, b_n, b_k, bs, bs_n, bs_g, n0, N, k0, K, tid);
    __syncthreads();
#pragma unroll
    for (int g = 0; g < BK / 16; ++g) nv_accumulate_group(acc, As, Bs, Sa, Sb, g, tx, ty);
    __syncthreads();
  }
  store(c, acc, *alpha_ptr, m0, n0, M, N, tx, ty);
}

}  // namespace

extern "C" int qt_gemm_fp4_nv(const void* a, long long a_m, long long a_k, const void* as,
                              long long as_m, long long as_g, const void* b, long long b_n,
                              long long b_k, const void* bs, long long bs_n, long long bs_g,
                              const void* alpha, void* c, int out_f32, int M, int N, int K,
                              void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const cudaStream_t st = (cudaStream_t)stream;
  if (out_f32)
    gemm_fp4_nv_kernel<float><<<grid, THREADS, 0, st>>>(
        (const uint8_t*)a, a_m, a_k, (const uint8_t*)as, as_m, as_g, (const uint8_t*)b, b_n, b_k,
        (const uint8_t*)bs, bs_n, bs_g, (const float*)alpha, (float*)c, M, N, K);
  else
    gemm_fp4_nv_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        (const uint8_t*)a, a_m, a_k, (const uint8_t*)as, as_m, as_g, (const uint8_t*)b, b_n, b_k,
        (const uint8_t*)bs, bs_n, bs_g, (const float*)alpha, (__nv_bfloat16*)c, M, N, K);
  return (int)cudaGetLastError();
}
