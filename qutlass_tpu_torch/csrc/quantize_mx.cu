// K1 quantize_mx: fused rotation + MXFP4 quantization (group 32, e8m0).
//
// Replaces the Pallas kernel qutlass_tpu/kernels/quantize.py:
// fused_quantize_mx (body _quantize_mx_kernel, :81-114).
//
// What bounds it on the H100: bytes.  It reads 2 bytes and writes about
// 0.6 byte per element, and does `rot` fp32 FMAs per element for the
// rotation (at most 128): far below the card's ratio of about 20 fp32
// FMAs per byte of device memory, so device-memory traffic and the
// latency of the per-group shuffle reductions set its time.
//
// Design: a block owns a tile of 32 rows x 128 columns (128 is a multiple
// of every rotation size).  It loads the bf16 tile and the rotation
// matrix into shared memory once; one warp then handles one 32-group of
// one row, lane j producing rotated element j, so the group statistics
// (QuEST moments or abs-max) are warp shuffles and the clip-mask bytes
// one ballot.  Codes land in a shared-memory tile that is written out
// row-major or K-major with coalesced stores.
#include "common.cuh"

namespace {

constexpr int TR = 32;       // rows per block
constexpr int TK = 128;      // columns per block
constexpr int THREADS = 256;
constexpr int CSTRIDE = TR + 4;  // padded stride of the K-major code tile

// layout: 0 = row-major packed [rows, K/2], 1 = K-major packed [K/2, rows],
// 2 = K-major codes [K, rows].  Scale byte (row, g) goes to
// s[g * s_sg + row * s_sr]; mask byte (row, j) to m[j * m_sj + row * m_sr].
__global__ void __launch_bounds__(THREADS)
quantize_mx_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ h,
                   uint8_t* __restrict__ q, uint8_t* __restrict__ s, uint8_t* __restrict__ mask,
                   int rows, int k, int rot, int method, int layout, long long s_sg,
                   long long s_sr, long long m_sj, long long m_sr) {
  __shared__ __nv_bfloat16 h_s[128 * 128];
  __shared__ __nv_bfloat16 x_s[TR][TK];
  __shared__ uint8_t c_s[TK][CSTRIDE];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * TR, k0 = blockIdx.y * TK;
  const int kw = min(TK, k - k0);  // valid columns in this tile (a multiple of 32)

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
    const int byte = qt::group_scale_byte(v, method);
    const float qv = qt::group_q(v, byte, method);
    c_s[col][rr] = (uint8_t)qt::e2m1_code(qv);
    if (lane == 0) s[(long long)((k0 >> 5) + gg) * s_sg + (long long)row * s_sr] = (uint8_t)byte;
    if (mask != nullptr) {
      const unsigned bits = __ballot_sync(0xFFFFFFFFu, fabsf(qv) < 6.0f);
      if (lane < 4)
        mask[(long long)((k0 >> 3) + gg * 4 + lane) * m_sj + (long long)row * m_sr] =
            (uint8_t)(bits >> (8 * lane));
    }
  }
  __syncthreads();

  if (layout == 0) {
    const int half = TK / 2;
    for (int i = tid; i < TR * half; i += THREADS) {
      const int rr = i / half, kp = i % half, row = r0 + rr;
      if (row < rows && 2 * kp < kw)
        q[(long long)row * (k / 2) + k0 / 2 + kp] = c_s[2 * kp][rr] | (c_s[2 * kp + 1][rr] << 4);
    }
  } else if (layout == 1) {
    for (int i = tid; i < (TK / 2) * TR; i += THREADS) {
      const int kp = i / TR, rr = i % TR, row = r0 + rr;
      if (row < rows && 2 * kp < kw)
        q[(long long)(k0 / 2 + kp) * rows + row] = c_s[2 * kp][rr] | (c_s[2 * kp + 1][rr] << 4);
    }
  } else {
    for (int i = tid; i < TK * TR; i += THREADS) {
      const int kk = i / TR, rr = i % TR, row = r0 + rr;
      if (row < rows && kk < kw) q[(long long)(k0 + kk) * rows + row] = c_s[kk][rr];
    }
  }
}

}  // namespace

extern "C" int qt_quantize_mx(const void* x, const void* h, void* q, void* s, void* mask, int rows,
                              int k, int rot, int method, int layout, long long s_sg,
                              long long s_sr, long long m_sj, long long m_sr, void* stream) {
  const dim3 grid((rows + TR - 1) / TR, (k + TK - 1) / TK);
  quantize_mx_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)h, (uint8_t*)q, (uint8_t*)s, (uint8_t*)mask,
      rows, k, rot, method, layout, s_sg, s_sr, m_sj, m_sr);
  return (int)cudaGetLastError();
}

extern "C" const char* qt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
