// K10 mxfp4_transpose_mxfp8: an MXFP4 operand [M, N] (packed e2m1 u8
// [M, N/2], e8m0 bytes [M, N/32]) dequantized exactly, transposed, and
// requantized in 32-groups along M with the square-double rule of K8/K9
// (shared exponent floor(log2 amax) - 7 + 127, bf16 pre-round, e4m3
// RTNE): fp8 bytes [N, M] and exponent bytes [N, M/32].  The QAT
// backward's MXFP8 operand of W (for dgrad) and of X (for wgrad).
// K14 mxfp4_transpose_scaled: the same quantization points emitted as
// e4m3_value * 2^(e-127) in bf16 [N, M] (K8's epilogue: the fp32 product
// rounded once to bf16), the operand of plain bf16 GEMMs.
// K15 mxfp4_transpose_scaled_kmajor: K14 from the K-major operand of
// fusedQuantizeMx(layout="kmajor") (packed u8 [K/2, rows], e8m0 [K/32,
// rows]) read directly: bf16 [K, rows], groups of 32 along the rows, a
// last partial group zero-padded (the JAX op pads the rows to 256).
//
// Replaces qutlass_tpu/kernels/backward.py:_fp4t_fp8_kernel
// (mxfp4_transpose_mxfp8_2d, :341-357, :476-515), _fp4t_scaled_kernel
// (mxfp4_transpose_scaled_2d, :360-415) and _fp4t_scaled_kmajor_kernel
// (mxfp4_transpose_scaled_kmajor_2d, :418-473).  The TPU kernels take
// 1/2^(e-127) by the bit trick (254<<23) - bits, wrong at byte 0, and the
// K-major one decodes with the GEMM's SWAR decode, exact only for scale
// bytes 1..254; here the reciprocal is formed from the byte and every
// scale byte decodes exactly (e2m1_decode_scaled).
//
// What bounds them on the H100: bytes (0.5 B read and 1 B (K10) or 2 B
// (K14, K15) written per element).  K10/K14 design: a block of 256 threads
// owns 32 rows (one group along M) x 64 columns.  Each thread reads 4
// packed bytes of one row, decodes its 8 values exactly into a padded fp32
// tile in shared memory; then each warp takes 8 columns, lane i holding
// row i, so a group's maximum is one warp reduction and each output row
// segment is 32 contiguous bytes (64 in bf16).  K15 needs no transpose:
// lane i holds row i of one K-major byte row, so a warp reads 32
// contiguous bytes and writes two 64-byte bf16 row segments.
#include "common.cuh"

namespace {

constexpr int TN = 64;  // columns per block

// the requantized value of v in its 32-group along the lanes: (e4m3 byte,
// shared exponent byte)
__device__ __forceinline__ int requant_fp8(float v, int& e) {
  const float amax = qt::warp_max(fabsf(v));
  e = __any_sync(0xFFFFFFFFu, v != v) ? 127 : qt::mxfp8_shared_exp(amax);
  return qt::e4m3_byte(qt::bf16_round(__fmul_rn(v, qt::mxfp8_inv_scale(e))));
}

// e4m3 byte x 2^(e-127) as bf16 bits (K8's epilogue)
__device__ __forceinline__ unsigned short scaled_bits(int byte, int e) {
  return qt::bf16_bits(__fmul_rn(qt::e4m3_decode(byte), qt::e8m0_decode(e)));
}

template <bool SCALED>
__global__ void __launch_bounds__(256)
transpose_mxfp8_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ sf,
                       long long sf_r, long long sf_g, uint8_t* __restrict__ fp8,
                       uint8_t* __restrict__ ebytes, unsigned short* __restrict__ out, int M,
                       int N) {
  __shared__ float tile[32][TN + 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * 32, n0 = blockIdx.x * TN;

  {  // load and decode: thread -> row tid / 8, columns 8 * (tid % 8) .. + 8
    const int r = tid >> 3, c = (tid & 7) * 8, n = n0 + c;
    if (n < N) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(q + (long long)(m0 + r) * (N / 2) + n / 2);
      const int sb = sf[(long long)(m0 + r) * sf_r + (long long)(n / 32) * sf_g];
#pragma unroll
      for (int j = 0; j < 8; ++j) tile[r][c + j] = qt::e2m1_decode_scaled((w >> (4 * j)) & 0xF, sb);
    }
  }
  __syncthreads();

  const int mg = M / 32;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = warp * 8 + j, n = n0 + c;
    if (n >= N) break;  // uniform across the warp
    int e;
    const int byte = requant_fp8(tile[lane][c], e);
    if constexpr (SCALED) {
      out[(long long)n * M + m0 + lane] = scaled_bits(byte, e);
    } else {
      fp8[(long long)n * M + m0 + lane] = (uint8_t)byte;
      if (lane == 0) ebytes[(long long)n * mg + blockIdx.y] = (uint8_t)e;
    }
  }
}

constexpr int KP = 32;  // K-major byte rows (64 values of K) per K15 block

// K15: qt u8 [K/2, rows], st u8 [K/32, rows], both contiguous; out bf16
// [K, rows].  A block of 8 warps covers 32 rows x KP byte rows.
__global__ void __launch_bounds__(256)
transpose_scaled_kmajor_kernel(const uint8_t* __restrict__ qt_, const uint8_t* __restrict__ st,
                               unsigned short* __restrict__ out, int K, int rows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x * 32 + lane;
  const bool live = r < rows;  // rows past the end are zero values (the JAX pad)
  for (int i = warp; i < KP; i += 8) {
    const int kp = blockIdx.y * KP + i;
    if (2 * kp >= K) break;  // uniform across the warp
    const int w = live ? qt_[(long long)kp * rows + r] : 0;
    const int sb = live ? st[(long long)(kp / 16) * rows + r] : 127;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      int e;
      const int byte = requant_fp8(qt::e2m1_decode_scaled((w >> (4 * j)) & 0xF, sb), e);
      if (live) out[(long long)(2 * kp + j) * rows + r] = scaled_bits(byte, e);
    }
  }
}

}  // namespace

// q u8 [M, N/2] contiguous (4-byte aligned); sf: e8m0 [M, N/32] with
// strides (sf_r, sf_g); M, N multiples of 32.  out == null (K10): fp8 u8
// [N, M] and ebytes u8 [N, M/32]; else (K14) out bf16 [N, M].
extern "C" int qt_mxfp4_transpose_mxfp8(const void* q, const void* sf, long long sf_r,
                                        long long sf_g, void* fp8, void* ebytes, void* out, int M,
                                        int N, void* stream) {
  const dim3 grid((N + TN - 1) / TN, M / 32);
  if (out != nullptr) {
    transpose_mxfp8_kernel<true><<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)q, (const uint8_t*)sf, sf_r, sf_g, nullptr, nullptr,
        (unsigned short*)out, M, N);
  } else {
    transpose_mxfp8_kernel<false><<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)q, (const uint8_t*)sf, sf_r, sf_g, (uint8_t*)fp8, (uint8_t*)ebytes,
        nullptr, M, N);
  }
  return (int)cudaGetLastError();
}

// K15: qt u8 [K/2, rows], st u8 [K/32, rows] contiguous, K a multiple of
// 32, any rows; out bf16 [K, rows].
extern "C" int qt_mxfp4_transpose_scaled_kmajor(const void* qt_, const void* st, void* out, int K,
                                                int rows, void* stream) {
  const dim3 grid((rows + 31) / 32, (K / 2 + KP - 1) / KP);
  transpose_scaled_kmajor_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)qt_, (const uint8_t*)st, (unsigned short*)out, K, rows);
  return (int)cudaGetLastError();
}
