// K8 square_double_scaled and K9 square_double_mxfp8: the QAT backward's
// square-double MXFP8 quantization of the output gradient dY [M, N] bf16.
// Each 32x32 tile gets one shared exponent e = mxfp8_shared_exp(tile
// amax); each value is multiplied by 2^(127-e), rounded to bf16, then to
// e4m3 (RTNE, saturating).  K9 writes the e4m3 bytes [M, N] and the
// exponent matrix [M/32, N/32]; K8 writes e4m3_value * 2^(e-127) as bf16
// [M, N] (exact but for underflow), the operand of plain bf16 GEMMs.
//
// Replaces qutlass_tpu/kernels/backward.py:_square_double_kernel
// (backward_bf16_square_double_mxfp8_2d, :233-274) and
// _square_double_scaled_kernel (backward_square_double_scaled_2d,
// :277-334).  The TPU kernels expand the tile scales with 0/1 indicator
// matmuls (a Mosaic workaround) and take the reciprocal by a bit trick
// that is wrong for byte 0; here one warp owns a tile, and the reciprocal
// is the exact power of two formed from the byte (mxfp8_inv_scale), so the
// kernel equals the plain version (ops/emulation.py:square_double_tiles).
//
// What bounds it on the H100: bytes (2 B read and 1 or 2 B written per
// element, no reuse).  Design: a block of 8 warps covers 32 rows x 256
// columns; lane j of a warp holds column j of its tile in 32 registers,
// so the tile maximum is one warp reduction and each row is read and
// written by the warp as one contiguous 64- or 32-byte segment.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;

template <bool SCALED>
__global__ void __launch_bounds__(WARPS * 32)
square_double_kernel(const __nv_bfloat16* __restrict__ x, uint8_t* __restrict__ fp8,
                     uint8_t* __restrict__ ebytes, unsigned short* __restrict__ out, int M, int N) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile_c = blockIdx.x * WARPS + warp;  // tile column
  if (tile_c * 32 >= N) return;                  // whole warps only (N % 32 == 0)
  const int r0 = blockIdx.y * 32, c = tile_c * 32 + lane;

  float v[32];
  float amax = 0.f;
  bool nan = false;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    v[i] = __bfloat162float(x[(long long)(r0 + i) * N + c]);
    amax = fmaxf(amax, fabsf(v[i]));
    nan |= v[i] != v[i];
  }
  amax = qt::warp_max(amax);
  // a NaN makes the tile maximum NaN (as torch.amax gives it): byte 127
  const int e = __any_sync(0xFFFFFFFFu, nan) ? 127 : qt::mxfp8_shared_exp(amax);
  const float inv = qt::mxfp8_inv_scale(e);
  const float sc = qt::e8m0_decode(e);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int byte = qt::e4m3_byte(qt::bf16_round(__fmul_rn(v[i], inv)));
    const long long o = (long long)(r0 + i) * N + c;
    if constexpr (SCALED) {
      out[o] = qt::bf16_bits(__fmul_rn(qt::e4m3_decode(byte), sc));
    } else {
      fp8[o] = (uint8_t)byte;
    }
  }
  if (!SCALED && lane == 0) ebytes[(long long)blockIdx.y * (N / 32) + tile_c] = (uint8_t)e;
}

}  // namespace

// x bf16 [M, N] contiguous, M and N multiples of 32.  scaled != 0: out
// bf16 [M, N]; else fp8 u8 [M, N] and ebytes u8 [M/32, N/32].
extern "C" int qt_square_double(const void* x, void* fp8, void* ebytes, void* out, int M, int N,
                                int scaled, void* stream) {
  const dim3 grid((N / 32 + WARPS - 1) / WARPS, M / 32);
  if (scaled) {
    square_double_kernel<true><<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, nullptr, nullptr, (unsigned short*)out, M, N);
  } else {
    square_double_kernel<false><<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, (uint8_t*)fp8, (uint8_t*)ebytes, nullptr, M, N);
  }
  return (int)cudaGetLastError();
}
