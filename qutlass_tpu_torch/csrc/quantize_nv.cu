// K5 quantize_nv: fused rotation + NVFP4 quantization (group 16, e4m3
// scale bytes, abs-max scales through a global scale).
//
// Replaces the Pallas kernel qutlass_tpu/kernels/quantize.py:
// fused_quantize_nv (body _quantize_nv_kernel, :117-135).  On the serving
// path it quantizes each NV weight once and, with fp4-stored weights, the
// activation of every linear.
//
// What bounds it on the H100: bytes.  It reads 2 bytes and writes about
// 0.56 byte per element and does `rot` fp32 FMAs per element for the
// rotation (at most 128), below the card's ratio of about 20 fp32 FMAs
// per byte of device memory at rot <= 32; the per-group shuffles and the
// e4m3 encode are a few dozen integer operations per element on top.
//
// Design: K1's.  A block owns 32 rows x 128 columns, loads the tile and
// the rotation into shared memory once; one warp takes one 32-wide chunk
// of one row, lane j producing rotated element j, so each half warp holds
// one 16-group and its statistics (QuEST moments or abs-max) are
// half-warp xor shuffles.  The global scale is read from device memory,
// so a scale computed on the card needs no host round trip.  The scale
// arithmetic uses __fmul_rn/__fdiv_rn/__fsqrt_rn in the order of the
// plain version (codecs.nv_*_scale_bytes); only the rotation's sum order
// differs from it, which can move a scale byte where a value sits within
// an ulp of an e4m3 rounding boundary.  Codes go through a shared tile
// and are written row-major or K-major with coalesced stores.
#include "common.cuh"

namespace {

constexpr int TR = 32;       // rows per block
constexpr int TK = 128;      // columns per block
constexpr int THREADS = 256;
constexpr int CSTRIDE = TR + 4;  // padded stride of the K-major code tile

// layout: 0 = row-major packed [rows, K/2], 1 = K-major packed [K/2, rows].
// Scale byte (row, g) goes to s[g * s_sg + row * s_sr].
__global__ void __launch_bounds__(THREADS)
quantize_nv_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ h,
                   const float* __restrict__ gs_ptr, uint8_t* __restrict__ q,
                   uint8_t* __restrict__ s, int rows, int k, int rot, int method, int layout,
                   long long s_sg, long long s_sr) {
  __shared__ __nv_bfloat16 h_s[128 * 128];
  __shared__ __nv_bfloat16 x_s[TR][TK];
  __shared__ uint8_t c_s[TK][CSTRIDE];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * TR, k0 = blockIdx.y * TK;
  const int kw = min(TK, k - k0);  // valid columns in this tile (a multiple of 16)
  const float gs = *gs_ptr;

  for (int i = tid; i < rot * rot; i += THREADS) h_s[i] = h[i];
#pragma unroll
  for (int j = 0; j < TR * TK / THREADS; ++j) {
    const int i = tid + j * THREADS, rr = i / TK, cc = i % TK, row = r0 + rr;
    x_s[rr][cc] = (row < rows && cc < kw) ? x[(long long)row * k + k0 + cc] : __float2bfloat16(0.f);
  }
  __syncthreads();

  for (int p = warp; p < TR * 4; p += THREADS / 32) {
    const int rr = p >> 2, gg = p & 3, row = r0 + rr;
    if (row >= rows || gg * 32 >= kw) continue;  // warp-uniform
    const int col = gg * 32 + lane;
    const float v = qt::rotate_elem(x_s[rr], h_s, rot, col);
    const int byte = qt::nv_group_byte(v, method, gs);
    c_s[col][rr] = (uint8_t)qt::e2m1_code(__fmul_rn(v, qt::nv_mul(byte, method, gs)));
    if ((lane & 15) == 0 && col < kw)
      s[(long long)((k0 + col) >> 4) * s_sg + (long long)row * s_sr] = (uint8_t)byte;
  }
  __syncthreads();

  if (layout == 0) {
    const int half = TK / 2;
    for (int i = tid; i < TR * half; i += THREADS) {
      const int rr = i / half, kp = i % half, row = r0 + rr;
      if (row < rows && 2 * kp < kw)
        q[(long long)row * (k / 2) + k0 / 2 + kp] = c_s[2 * kp][rr] | (c_s[2 * kp + 1][rr] << 4);
    }
  } else {
    for (int i = tid; i < (TK / 2) * TR; i += THREADS) {
      const int kp = i / TR, rr = i % TR, row = r0 + rr;
      if (row < rows && 2 * kp < kw)
        q[(long long)(k0 / 2 + kp) * rows + row] = c_s[2 * kp][rr] | (c_s[2 * kp + 1][rr] << 4);
    }
  }
}

}  // namespace

extern "C" int qt_quantize_nv(const void* x, const void* h, const void* gs, void* q, void* s,
                              int rows, int k, int rot, int method, int layout, long long s_sg,
                              long long s_sr, void* stream) {
  const dim3 grid((rows + TR - 1) / TR, (k + TK - 1) / TK);
  quantize_nv_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)h, (const float*)gs, (uint8_t*)q,
      (uint8_t*)s, rows, k, rot, method, layout, s_sg, s_sr);
  return (int)cudaGetLastError();
}
