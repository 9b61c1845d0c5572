// K7 gemm_fp4_nv: the NVFP4 GEMM,
//   C[m, n] = out( float(sum_k dq(a)[m, k] * dq(b)[n, k]) * alpha ),
// dq = e2m1 value times its 16-group e4m3 scale; out = bf16 or fp32.
//
// Replaces the Pallas kernel qutlass_tpu/kernels/gemm.py:193 _run_gemm
// with fmt="nv", behind matmul_nvf4_bf16_tn and matmul_nvf4_bf16_kmajor
// (:255/:265): the GEMM of NVFP4 linears with fp4-stored weights.
//
// Exactness, and what the design does about it.  An e4m3 scale is not a
// power of two, so the fp32 partial sums of a plain fp32 accumulation
// are not exact: over K = 4096 they would round, and a bf16 result would
// differ from the fp64 reference at a rate near 1e-3.  Instead, per
// 16-group, both kernels below take the exact sum of the 16 unscaled
// e2m1 products as an integer: the doubled values m2 = 2v are integers
// in [-12, 12], their 16 products sum to s = 4p exactly (p the group's
// sum, a multiple of 1/4 up to 36).  The term p sa sb (12 + 4 + 4
// significant bits: exact) is added into an fp64 accumulator with one
// rounding, as fma(fma(MAGIC + s, sa / 4, -MAGIC sa / 4), sb, acc), the
// double MAGIC + s built from bits (no int -> fp conversion).  Every group
// term is a multiple of 2^-20 and the fp64 sums stay exact while a row
// pair's group terms span fewer than ~40 binades; there the result,
// rounded once to fp32 and scaled by alpha, is bitwise the plain
// version's (fp64 sum of exact products, rounded once), and the order in
// which the terms are added does not change a bit.  Outside that regime
// no order is bitwise against the plain version; the prefill kernel adds
// each output's terms in ascending k, as the fp4 tile of
// gemm_fp4_tile.cuh does for K17, so K17 equals K5 + K7 there too.
//
// The launcher picks one of two kernels:
//
// Decode (dec::gemm_fp4_decode<dec::Nv>, gemm_fp4_decode.cuh, shared with
// K4): the K-major layout at M <= 16, the serving path's call (weight
// packed [K/2, N], scales [K/16, N]; activation [K/2, M] and [K/16, M]).
// Bound by the weight bytes, 0.5625 byte an element (3.35 TB/s: 8.5 us at
// K x N = 4096 x 12288).  Split-K over blocks that stream the weight from
// device memory into registers; the last block of a column tile adds the
// fp64 partials in split order, in one launch and with no host sync.
//
// Prefill (gemm_fp4_prefill<dec::Nv>, gemm_fp4_prefill.cuh, shared with
// K4): every other call, the row-major (tn) layout at any M and the
// K-major one at M > 16.  Bound by the fp64 fold, two DFMA an output and
// group (33.5 TFLOP/s on the H100's CUDA cores: 0.19 ms at (M, K, N) =
// (512, 4096, 12288)), not by the int8 products.  Blocks of 64 x 64 (or 64
// x 32) outputs stage slabs of 64 k of both operands in shared memory as
// int8 m2; each 16-group of a 16 x 8 output tile is one
// mma.sync.m16n8k16 s8 x s8 -> s32 from a zero accumulator (k16 is one
// group: the k32 shape and wgmma would mix two groups with different
// scales), whose int32 results are the group's s; every output folds its
// terms in ascending k into one fp64 chain.  No split-K, no workspace, no
// counters: graph-safe by construction.
//
// alpha is read from device memory by both kernels.
#include "gemm_fp4_decode.cuh"
#include "gemm_fp4_prefill.cuh"

// a'[m, kp] = a[m * a_m + kp * a_k] (packed, kp = k / 2), a's scales
// as[m * as_m + g * as_g]; likewise b' [N, K/2] and bs; alpha fp32 on the
// device; c [M, N] bf16 or (out_f32) fp32; K % 16 == 0.  With part ==
// nullptr the prefill kernel runs, on any strides.  With part, the decode
// kernel (gemm_fp4_decode.cuh's dec::run): M <= 16, b and bs K-major (b_n
// == bs_n == 1), kc a multiple of 128 and at most 2048, part and counters
// as dec::run states.  What a kernel does not take returns
// cudaErrorInvalidValue.
extern "C" int qt_gemm_fp4_nv(const void* a, long long a_m, long long a_k, const void* as,
                              long long as_m, long long as_g, const void* b, long long b_n,
                              long long b_k, const void* bs, long long bs_n, long long bs_g,
                              const void* alpha, void* c, int out_f32, int M, int N, int K,
                              void* part, void* counters, int kc, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const uint8_t *ap = (const uint8_t*)a, *asp = (const uint8_t*)as;
  const uint8_t *bp = (const uint8_t*)b, *bsp = (const uint8_t*)bs;
  const float* al = (const float*)alpha;
  if (M <= 0 || N <= 0 || K <= 0 || K % 16) return (int)cudaErrorInvalidValue;
  if (part != nullptr) {
    if (b_n != 1 || bs_n != 1) return (int)cudaErrorInvalidValue;
    return dec::run<dec::Nv>(ap, a_m, a_k, asp, as_m, as_g, bp, b_k, bsp, bs_g, al, 0.f, c, out_f32,
                             M, N, K, kc, (double*)part, (int*)counters, st);
  }
  if (out_f32)
    return pre::run<dec::Nv, false>(ap, a_m, a_k, asp, as_m, as_g, bp, b_n, b_k, bsp, bs_n, bs_g,
                                    al, 0.f, (float*)c, M, N, K, st);
  return pre::run<dec::Nv, false>(ap, a_m, a_k, asp, as_m, as_g, bp, b_n, b_k, bsp, bs_n, bs_g, al,
                                  0.f, (__nv_bfloat16*)c, M, N, K, st);
}
