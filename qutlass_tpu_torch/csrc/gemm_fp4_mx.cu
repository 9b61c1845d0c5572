// K4 gemm_fp4_mx: the MXFP4 GEMM,
//   C[m, n] = out( float(sum_g p_g sa_g sb_g) * alpha ),
// p_g the exact sum of a 32-group's e2m1 products, sa_g and sb_g its two
// e8m0 scales 2^(byte - 127); out = bf16 or fp32 (the tensor-parallel
// partial sums' type).
//
// Replaces the Pallas kernel qutlass_tpu/kernels/gemm.py:_run_gemm with
// _gemm_fp4_kernel, fmt="mx" (:127-148), behind matmul_mxf4_bf16_tn,
// _kmajor and _kmajor_codes (:213-251): the fp4-weight fallback of the
// quantized linear and the reference-parity GEMM.
//
// Exactness.  A group's p (multiples of 1/4 up to 1152) is exact in int32
// as s = 4 p, and the term p sa sb is exact in fp64 for every scale byte
// (fp32 would overflow near byte 254 and flush near byte 0); the terms are
// added into one fp64 sum an output, rounded once to fp32, times alpha.
// While a row pair's group terms span fewer than ~40 binades the fp64 sums
// are exact, the order of the additions moves no bit, and the result is
// bitwise the plain version's (the fp64 sum of the exact products, rounded
// once) and so the JAX package's.  Beyond that regime the prefill kernel
// adds in ascending k, as K16 does (gemm_fp4_tile.cuh's
// mx_accumulate_group), so K16 equals K1 + K4 there too.  Where an
// operand's scale byte is 253 or 254 the plain version's bf16 dequant
// saturates to inf while the fold keeps the exact term; there, and where
// the fp64 sums round, the kernels are held to
// ops/emulation.gemm_fp4_mx_groupfold_plain.  Scale byte 255 gives NaN.
//
// The launcher picks one of two kernels:
//
// Decode (dec::gemm_fp4_decode<dec::Mx>, gemm_fp4_decode.cuh, shared with
// K7): the K-major layout at M <= 16, the serving path's call (weight
// packed [K/2, N], scales [K/32, N], unit stride along N).  Bound by the
// weight bytes, 0.53125 byte an element (8.0 us at K x N = 4096 x 12288).
// Split-K over blocks that stream the weight into registers, each
// 32-group's s from eight __dp4a, the fp64 partials added in split order
// by the last block of a column tile, in one launch with no host sync.
//
// Prefill (gemm_fp4_prefill<dec::Mx>, gemm_fp4_prefill.cuh, shared with
// K7): every other call (tn at any M, kmajor above 16 rows, kmajor_codes).
// Bound by the fp64 fold, two DFMA an output and 32-group (33.5 TFLOP/s on
// the H100's CUDA cores: 0.096 ms at (M, K, N) = (512, 4096, 12288)), not
// by the int8 products (0.026 ms).  Blocks of 64 x 64 (or 64 x 32)
// outputs stage slabs of 64 k (two 32-groups) of both operands in shared
// memory as int8 m2; each 32-group of a 16 x 8 output tile is one
// mma.sync.m16n8k32 s8 x s8 -> s32 from a zero accumulator, whose int32
// results are the group's s, folded as
// fma(fma(MAGIC + s, sa / 4, -MAGIC sa / 4), sb, acc) in ascending k: acc
// + p sa sb rounded once, bitwise the fp4 tile's fold.  Packed operands of
// contiguous rows take 4-byte loads, other strides byte loads; unpacked
// activation codes (kmajor_codes) are read a byte a k and packed as they
// arrive.  No workspace, no counters: graph-safe.
//
// Both kernels read alpha from device memory, or take a number by value
// (alpha null): no host sync and no launch for it.
#include "gemm_fp4_decode.cuh"
#include "gemm_fp4_prefill.cuh"

// a'[m, k] = a[m * a_m + (k / 2) * a_k] (packed, element 2i in the low
// nibble) or a[m * a_m + k * a_k] (codes, a_packed 0), a's scales
// as[m * as_m + g * as_g]; likewise b' [N, K] and bs; alpha fp32 on the
// device, or alpha_val where alpha is null; c [M, N] bf16 or (out_f32)
// fp32; K % 32 == 0; b packed.  With part == nullptr the prefill kernel
// runs, on any strides.  With part, the decode kernel (dec::run): packed
// operands, M <= 16, b and bs K-major (b_n == bs_n == 1), kc a multiple
// of 256 and at most 2048, part and counters as dec::run states.  What a
// kernel does not take returns cudaErrorInvalidValue.
extern "C" int qt_gemm_fp4_mx(const void* a, long long a_m, long long a_k, int a_packed,
                              const void* as, long long as_m, long long as_g, const void* b,
                              long long b_n, long long b_k, int b_packed, const void* bs,
                              long long bs_n, long long bs_g, const void* alpha,
                              float alpha_val, void* c, int out_f32, int M, int N, int K,
                              void* part, void* counters, int kc, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const uint8_t *ap = (const uint8_t*)a, *asp = (const uint8_t*)as;
  const uint8_t *bp = (const uint8_t*)b, *bsp = (const uint8_t*)bs;
  const float* al = (const float*)alpha;
  if (M <= 0 || N <= 0 || K <= 0 || K % 32) return (int)cudaErrorInvalidValue;
  if (part != nullptr) {
    if (!a_packed || !b_packed || b_n != 1 || bs_n != 1) return (int)cudaErrorInvalidValue;
    return dec::run<dec::Mx>(ap, a_m, a_k, asp, as_m, as_g, bp, b_k, bsp, bs_g, al, alpha_val, c,
                             out_f32, M, N, K, kc, (double*)part, (int*)counters, st);
  }
  if (!b_packed) return (int)cudaErrorInvalidValue;
  if (out_f32)
    return a_packed ? pre::run<dec::Mx, false>(ap, a_m, a_k, asp, as_m, as_g, bp, b_n, b_k, bsp,
                                               bs_n, bs_g, al, alpha_val, (float*)c, M, N, K, st)
                    : pre::run<dec::Mx, true>(ap, a_m, a_k, asp, as_m, as_g, bp, b_n, b_k, bsp,
                                              bs_n, bs_g, al, alpha_val, (float*)c, M, N, K, st);
  __nv_bfloat16* cb = (__nv_bfloat16*)c;
  return a_packed ? pre::run<dec::Mx, false>(ap, a_m, a_k, asp, as_m, as_g, bp, b_n, b_k, bsp, bs_n,
                                             bs_g, al, alpha_val, cb, M, N, K, st)
                  : pre::run<dec::Mx, true>(ap, a_m, a_k, asp, as_m, as_g, bp, b_n, b_k, bsp, bs_n,
                                            bs_g, al, alpha_val, cb, M, N, K, st);
}
