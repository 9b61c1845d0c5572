// K16 fused_linear_mx and K17 fused_linear_nv: the single-kernel W4A4
// linear,
//   y[m, n] = bf16( (sum_k dq(q(x H))[m, k] * dq(w)[n, k]) * alpha ),
// the activation x [M, K] rotated, quantized and dequantized inside the
// GEMM against a pre-quantized K-major weight (packed [K/2, N], scales
// [K/32, N] e8m0 for MX, [K/16, N] e4m3 for NV).
//
// Replaces the Pallas kernel qutlass_tpu/kernels/fused_linear.py:_run_fused
// (:144, body _fused_linear_kernel, :108-131) with fmt "mx" (K16) and "nv"
// (K17), behind fused_linear_mxf4 / fused_linear_nvf4 under
// QUTLASS_TPU_FUSED_LINEAR.
//
// What bounds it on the H100: at decode the weight bytes (0.53 or 0.56
// byte a weight element); at prefill the CUDA cores' fp32 rate, since
// this first version accumulates on them (the fp4 tile of
// gemm_fp4_tile.cuh), where K4 and K7 sum on the tensor cores.
//
// Exactness by construction: each output is bitwise the composition K1 +
// K4 (K5 + K7).  The activation of every 128-column slab is quantized with
// the device functions of K1 (rotate_elem, group_scale_byte, group_q,
// e2m1_code) or K5 (nv_group_byte, nv_mul), one warp per 32 columns of a
// row as there, and decoded as K4 (e2m1_value and e8m0_decode) or K7
// (e2m1_value and e4m3_decode) decode the quantizer's bytes.  The
// weight's decode, the sums and the epilogue are the fp4 tile's
// (gemm_fp4_tile.cuh): per group the exact fp32 sum of its e2m1
// products, times both scales (in fp64 for MX's powers of two, in fp32
// for NV's e4m3 values: exact either way), added into fp64 in ascending
// k, rounded once, then * alpha.  K4's and K7's prefill kernel
// (gemm_fp4_prefill.cuh) adds the same exact terms in the same order.  alpha and the NV activation global scale are read from
// device memory.
//
// Design: 64x64 output tiles, 256 threads of 4x4 outputs each (K4's
// tile).  K is walked in slabs of 128 columns, a multiple of every
// rotation size and of both group sizes; a last partial slab (K = 96, or
// 48 for NV) is zero-padded and its sums stop at the valid columns.
// Every block quantizes its 64 rows of x again for each 64-column block
// of N, as the TPU kernel's first design did: (N/64) times the
// quantization work of K1, for the decode and small-prefill sizes (M <=
// 64) this kernel is for; at M = 64 it doubles the NV call (PERF.md).
// Shared memory is dynamic (up to 115.7 KB at rotation 128): the decoded A
// and B slabs as fp32 [128][65], the x slab bf16 [64][128], the rotation
// [rot][rot], and the slabs' decoded scales.
#include "gemm_fp4_tile.cuh"

namespace {

using namespace qt::tile;
constexpr int BK = 128;
constexpr int NG = BK / 16;      // NV scale groups per slab
constexpr int FMT_MX = 0, FMT_NV = 1;
constexpr int kMaxDevices = 64;

constexpr size_t kSlabBytes = sizeof(float) * BK * PAD;
constexpr size_t kScaleBytes = sizeof(float) * NG * BM;
constexpr size_t kXBytes = sizeof(__nv_bfloat16) * BM * BK;

size_t smem_bytes(int rot) {
  return 2 * kSlabBytes + 2 * kScaleBytes + kXBytes + sizeof(__nv_bfloat16) * rot * rot;
}

template <int FMT>
__global__ void __launch_bounds__(THREADS)
fused_linear_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ h,
                    const float* __restrict__ gs_ptr, const uint8_t* __restrict__ b,
                    long long b_n, long long b_k, const uint8_t* __restrict__ bs, long long bs_n,
                    long long bs_g, const float* __restrict__ alpha_ptr,
                    __nv_bfloat16* __restrict__ c, int M, int N, int K, int rot, int method) {
  extern __shared__ __align__(16) unsigned char smem[];
  float (*As)[PAD] = reinterpret_cast<float (*)[PAD]>(smem);
  float (*Bs)[PAD] = reinterpret_cast<float (*)[PAD]>(smem + kSlabBytes);
  float (*Sa)[BM] = reinterpret_cast<float (*)[BM]>(smem + 2 * kSlabBytes);  // [NG][BM]
  float (*Sb)[BN] = reinterpret_cast<float (*)[BN]>(smem + 2 * kSlabBytes + kScaleBytes);
  unsigned char* rest = smem + 2 * kSlabBytes + 2 * kScaleBytes;
  __nv_bfloat16 (*xs)[BK] = reinterpret_cast<__nv_bfloat16 (*)[BK]>(rest);
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(rest + kXBytes);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int rows = min(BM, M - m0);  // valid rows of x in this block
  float gs = 0.f;
  if constexpr (FMT == FMT_NV) gs = *gs_ptr;

  for (int i = tid; i < rot * rot; i += THREADS) hs[i] = h[i];

  double acc[4][4];
  zero(acc);

  for (int k0 = 0; k0 < K; k0 += BK) {
    const int kw = min(BK, K - k0);  // valid columns of this slab
    for (int i = tid; i < rows * BK; i += THREADS) {
      const int rr = i / BK, cc = i % BK;
      xs[rr][cc] = cc < kw ? x[(long long)(m0 + rr) * K + k0 + cc] : __float2bfloat16(0.f);
    }
    if constexpr (FMT == FMT_MX)
      decode_mx<BK>(Bs, Sb, b, b_n, b_k, 1, bs, bs_n, bs_g, n0, N, k0, K, tid);
    else
      decode_nv<BK>(Bs, Sb, b, b_n, b_k, bs, bs_n, bs_g, n0, N, k0, K, tid);
    __syncthreads();

    // the activation slab: K1's (K5's) quantizer, one warp per 32 columns
    // of a row, lane j producing column j; decoded as K4 (K7) decodes it
    for (int p = warp; p < rows * 4; p += THREADS / 32) {
      const int rr = p >> 2, gg = p & 3;
      if (gg * 32 >= kw) continue;  // warp-uniform
      const int col = gg * 32 + lane;
      const float v = qt::rotate_elem(xs[rr], hs, rot, col);
      if constexpr (FMT == FMT_MX) {
        const int byte = qt::group_scale_byte(v, method);
        As[col][rr] = qt::e2m1_value(qt::e2m1_code(qt::group_q(v, byte, method)));
        if (lane == 0) Sa[col >> 5][rr] = qt::e8m0_decode(byte);
      } else {
        const int byte = qt::nv_group_byte(v, method, gs);
        As[col][rr] = qt::e2m1_value(qt::e2m1_code(__fmul_rn(v, qt::nv_mul(byte, method, gs))));
        if ((lane & 15) == 0) Sa[col >> 4][rr] = qt::e4m3_decode(byte);
      }
    }
    __syncthreads();

    if constexpr (FMT == FMT_MX)
      for (int g = 0; g < kw / 32; ++g) mx_accumulate_group(acc, As, Bs, Sa, Sb, g, tx, ty);
    else
      for (int g = 0; g < kw / 16; ++g) nv_accumulate_group(acc, As, Bs, Sa, Sb, g, tx, ty);
    __syncthreads();
  }
  store(c, acc, *alpha_ptr, m0, n0, M, N, tx, ty);
}

// The dynamic shared memory allowed, set once per device at the largest
// rotation's size (the attribute call costs host time at every launch)
template <int FMT>
cudaError_t allow_smem() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev])) return err;
  err = cudaFuncSetAttribute(fused_linear_kernel<FMT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes(128));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <int FMT>
int launch(const void* x, const void* h, const void* gs, const void* b, long long b_n,
           long long b_k, const void* bs, long long bs_n, long long bs_g, const void* alpha,
           void* c, int M, int N, int K, int rot, int method, void* stream) {
  const cudaError_t err = allow_smem<FMT>();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  fused_linear_kernel<FMT><<<grid, THREADS, smem_bytes(rot), (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)h, (const float*)gs, (const uint8_t*)b, b_n,
      b_k, (const uint8_t*)bs, bs_n, bs_g, (const float*)alpha, (__nv_bfloat16*)c, M, N, K, rot,
      method);
  return (int)cudaGetLastError();
}

}  // namespace

// x bf16 [M, K] row-major; h [rot, rot] bf16; the weight as its logical
// [N, K/2] packed view b[n * b_n + kp * b_k] with scales bs[n * bs_n + g *
// bs_g]; alpha (and the NV global scale gs) one fp32 in device memory.
extern "C" int qt_fused_linear_mx(const void* x, const void* h, const void* b, long long b_n,
                                  long long b_k, const void* bs, long long bs_n, long long bs_g,
                                  const void* alpha, void* c, int M, int N, int K, int rot,
                                  int method, void* stream) {
  return launch<FMT_MX>(x, h, nullptr, b, b_n, b_k, bs, bs_n, bs_g, alpha, c, M, N, K, rot, method,
                        stream);
}

extern "C" int qt_fused_linear_nv(const void* x, const void* h, const void* gs, const void* b,
                                  long long b_n, long long b_k, const void* bs, long long bs_n,
                                  long long bs_g, const void* alpha, void* c, int M, int N, int K,
                                  int rot, int method, void* stream) {
  return launch<FMT_NV>(x, h, gs, b, b_n, b_k, bs, bs_n, bs_g, alpha, c, M, N, K, rot, method,
                        stream);
}
