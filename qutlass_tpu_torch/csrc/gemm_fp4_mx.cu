// K4 gemm_fp4_mx: the MXFP4 decode GEMM,
//   C[m, n] = out( (sum_k dq(a)[m, k] * dq(b)[n, k]) * alpha ),
// dq = e2m1 code times its 32-group e8m0 scale, exact in bf16; out = bf16
// or fp32 (the tensor-parallel partial sums' type).
//
// Replaces the Pallas kernel qutlass_tpu/kernels/gemm.py:_run_gemm with
// _gemm_fp4_kernel, fmt="mx" (:127-148), behind matmul_mxf4_bf16_tn,
// _kmajor and _kmajor_codes (:213-251): the fp4-weight fallback of the
// quantized linear and the reference-parity GEMM.
//
// What bounds it on the H100: fp32 FMA rate.  This first version
// accumulates on the CUDA cores, not the tensor cores (67 TFLOP/s fp32
// against 989 bf16), because an fp32 FMA of two exact products rounds
// exactly like the fp64 reference whenever the partial sums are exact,
// which makes the result bit-exact against bf16(fp64 dequant matmul).
//
// Design: 64x64 output tiles, 256 threads of 4x4 outputs each (the tile
// of gemm_fp4_tile.cuh, shared with K16).  Every K step of 32 (one scale
// group) decodes a 32x64 slab of each operand with the integer formula of
// codecs.e2m1_decode_scaled_bf16 (exact for every scale byte, 0 included;
// the TPU's SWAR trick is not, and is not used) into shared memory as
// fp32.  Operands and scales are read through strides, so the row-major,
// K-major and unpacked-codes layouts share the kernel.
#include "gemm_fp4_tile.cuh"

namespace {

using namespace qt::tile;
constexpr int BK = 32;  // one scale group

template <typename Out>
__global__ void __launch_bounds__(THREADS)
gemm_fp4_mx_kernel(const uint8_t* __restrict__ a, long long a_m, long long a_k, int a_packed,
                   const uint8_t* __restrict__ as, long long as_m, long long as_g,
                   const uint8_t* __restrict__ b, long long b_n, long long b_k, int b_packed,
                   const uint8_t* __restrict__ bs, long long bs_n, long long bs_g, float alpha,
                   Out* __restrict__ c, int M, int N, int K) {
  __shared__ float As[BK][PAD];
  __shared__ float Bs[BK][PAD];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[4][4];
  zero(acc);
  for (int k0 = 0; k0 < K; k0 += BK) {
    decode_mx<BK>(As, a, a_m, a_k, a_packed, as, as_m, as_g, m0, M, k0, K, tid);
    decode_mx<BK>(Bs, b, b_n, b_k, b_packed, bs, bs_n, bs_g, n0, N, k0, K, tid);
    __syncthreads();
    mx_accumulate(acc, As, Bs, BK, tx, ty);
    __syncthreads();
  }
  store(c, acc, alpha, m0, n0, M, N, tx, ty);
}

}  // namespace

extern "C" int qt_gemm_fp4_mx(const void* a, long long a_m, long long a_k, int a_packed,
                              const void* as, long long as_m, long long as_g, const void* b,
                              long long b_n, long long b_k, int b_packed, const void* bs,
                              long long bs_n, long long bs_g, float alpha, void* c, int out_f32,
                              int M, int N, int K, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const cudaStream_t st = (cudaStream_t)stream;
  if (out_f32)
    gemm_fp4_mx_kernel<float><<<grid, THREADS, 0, st>>>(
        (const uint8_t*)a, a_m, a_k, a_packed, (const uint8_t*)as, as_m, as_g, (const uint8_t*)b, b_n,
        b_k, b_packed, (const uint8_t*)bs, bs_n, bs_g, alpha, (float*)c, M, N, K);
  else
    gemm_fp4_mx_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        (const uint8_t*)a, a_m, a_k, a_packed, (const uint8_t*)as, as_m, as_g, (const uint8_t*)b, b_n,
        b_k, b_packed, (const uint8_t*)bs, bs_n, bs_g, alpha, (__nv_bfloat16*)c, M, N, K);
  return (int)cudaGetLastError();
}
