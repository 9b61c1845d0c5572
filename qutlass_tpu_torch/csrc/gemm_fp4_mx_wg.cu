// K4's warp-specialised MXFP4 prefill kernel (gemm_fp4_prefill_wg.cuh)
// behind a C entry point of its own.  This source is not in the kernel
// library (kernels/_build.SOURCES): no call of the port runs the kernel.
// tools/time_nv_prefill.py, chip_smoke.py phase 2 and the `gpu` tests
// build it on demand (tools/_variants.build) and hold it bitwise to K4's
// prefill kernel and to the plain version before they time it.
//
// The same GEMM as gemm_fp4_mx.cu, on both operands packed K-major: a
// [K/2, M] with its scales [K/32, M], b [K/2, N] with [K/32, N], unit stride
// along M and N (a_m == as_m == b_n == bs_n == 1), any base and k-row
// stride, K % 32 == 0; alpha fp32 on the device, or alpha_val where alpha
// is null; c [M, N] bf16 or (out_f32) fp32.  What it does not take returns
// cudaErrorInvalidValue.  No workspace, no counters: graph-safe.
#include "gemm_fp4_prefill_wg.cuh"

extern "C" int qt_gemm_fp4_mx_wg(const void* a, long long a_m, long long a_k, const void* as,
                                 long long as_m, long long as_g, const void* b, long long b_n,
                                 long long b_k, const void* bs, long long bs_n, long long bs_g,
                                 const void* alpha, float alpha_val, void* c, int out_f32, int M,
                                 int N, int K, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const uint8_t *ap = (const uint8_t*)a, *asp = (const uint8_t*)as;
  const uint8_t *bp = (const uint8_t*)b, *bsp = (const uint8_t*)bs;
  const float* al = (const float*)alpha;
  if (M <= 0 || N <= 0 || K <= 0 || K % 32) return (int)cudaErrorInvalidValue;
  return out_f32 ? pwg::run(ap, a_m, a_k, asp, as_m, as_g, bp, b_n, b_k, bsp, bs_n, bs_g, al,
                            alpha_val, (float*)c, M, N, K, st)
                 : pwg::run(ap, a_m, a_k, asp, as_m, as_g, bp, b_n, b_k, bsp, bs_n, bs_g, al,
                            alpha_val, (__nv_bfloat16*)c, M, N, K, st);
}
