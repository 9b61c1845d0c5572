// K10 mxfp4_transpose_mxfp8: an MXFP4 operand [M, N] (packed e2m1 u8
// [M, N/2], e8m0 bytes [M, N/32]) dequantized exactly, transposed, and
// requantized in 32-groups along M with the square-double rule of K8/K9
// (shared exponent floor(log2 amax) - 7 + 127, bf16 pre-round, e4m3
// RTNE): fp8 bytes [N, M] and exponent bytes [N, M/32].  The QAT
// backward's MXFP8 operand of W (for dgrad) and of X (for wgrad).
//
// Replaces qutlass_tpu/kernels/backward.py:_fp4t_fp8_kernel
// (mxfp4_transpose_mxfp8_2d, :341-357, :476-515).
//
// What bounds it on the H100: bytes (0.5 B read and 1 B written per
// element).  Design: a block of 256 threads owns 32 rows (one group along
// M) x 64 columns.  Each thread reads 4 packed bytes of one row, decodes
// its 8 values exactly (e2m1_decode_scaled, every scale byte included)
// into a padded fp32 tile in shared memory; then each warp takes 8
// columns, lane i holding row i, so a group's maximum is one warp
// reduction and each output row segment is 32 contiguous bytes.
#include "common.cuh"

namespace {

constexpr int TN = 64;  // columns per block

__global__ void __launch_bounds__(256)
transpose_mxfp8_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ sf,
                       long long sf_r, long long sf_g, uint8_t* __restrict__ fp8,
                       uint8_t* __restrict__ ebytes, int M, int N) {
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
    const float v = tile[lane][c];
    const float amax = qt::warp_max(fabsf(v));
    const int e = __any_sync(0xFFFFFFFFu, v != v) ? 127 : qt::mxfp8_shared_exp(amax);
    const int byte = qt::e4m3_byte(qt::bf16_round(__fmul_rn(v, qt::mxfp8_inv_scale(e))));
    fp8[(long long)n * M + m0 + lane] = (uint8_t)byte;
    if (lane == 0) ebytes[(long long)n * mg + blockIdx.y] = (uint8_t)e;
  }
}

}  // namespace

// q u8 [M, N/2] contiguous (4-byte aligned); sf: e8m0 [M, N/32] with
// strides (sf_r, sf_g); M, N multiples of 32.  fp8 u8 [N, M], ebytes u8
// [N, M/32].
extern "C" int qt_mxfp4_transpose_mxfp8(const void* q, const void* sf, long long sf_r,
                                        long long sf_g, void* fp8, void* ebytes, int M, int N,
                                        void* stream) {
  const dim3 grid((N + TN - 1) / TN, M / 32);
  transpose_mxfp8_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)q, (const uint8_t*)sf, sf_r, sf_g, (uint8_t*)fp8, (uint8_t*)ebytes, M, N);
  return (int)cudaGetLastError();
}
