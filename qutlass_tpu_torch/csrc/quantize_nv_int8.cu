// K6 quantize_nv_int8: fused rotation + NVFP4 quantization + int8 encode,
// the activation quantizer of every NVFP4 linear with int8-stored weights.
//
// Replaces the Pallas kernel qutlass_tpu/kernels/quantize.py:
// fused_quantize_nv_int8 (bodies _quantize_nv_int8_oneshot_kernel :467
// and _quantize_nv_int8_kernel :535, which compute the same thing).
// Outputs a' int8 [K, rows] in natural K order, sigma f32 [rows] and the
// e4m3 scale bytes u8 [K/16, rows], equal to fused_quantize_nv(kmajor) +
// int8path.encode_nv_int8: with v = m2 * (0.5 * s_g) (exact in fp32),
// sigma = rowmax|v| * float32(1/127) (the JAX package's "/ 127.0" as XLA
// compiles it) and a' = rtne(v * (1 / sigma)).
//
// What bounds it on the H100: bytes at prefill, and at decode (rows = 4)
// the number of SMs that get work.  Each row needs its maximum |v| over
// all of K before any a' can be written.  K2 (the MX twin) gives one block
// all of a block of rows and walks K twice, so at decode one SM of 132
// works.  This kernel splits K across blocks instead, in two launches on
// the same grid of (row blocks) x (128-column chunks): 32 blocks at
// K = 4096 and 96 at K = 12288 for 4 rows, 2048 and more at prefill.
//   pass A  rotates its chunk, writes the chunk's scale bytes, and folds
//           the chunk's contribution into the row maximum with one
//           atomicMax per row on the fp32 bits (the values are >= 0, so
//           their bits order as integers; the maximum is exact and so
//           independent of the order of the blocks).  It needs no codes:
//           e2m1 rounding is monotone, so a group's largest |v| is
//           0.5 * s_g * m2(code(amax_g * mul_g)).
//   pass B  recomputes the rotation (cheaper than a round trip of 4
//           bytes per element), reads the group's byte back, and emits a'
//           with sigma from the finished row maximum.
// The scale arithmetic is the plain version's, in its order, with
// __fmul_rn/__fdiv_rn/__fsqrt_rn.
#include "common.cuh"

namespace {

constexpr int TR = 8;        // rows per block
constexpr int TK = 128;      // columns per block
constexpr int THREADS = 256;
constexpr int ASTRIDE = TR + 4;  // padded stride of the K-major a' tile
constexpr float kInv127 = (float)(1.0 / 127.0);

__device__ __forceinline__ void load_tile(__nv_bfloat16* h_s, __nv_bfloat16 (*x_s)[TK],
                                          const __nv_bfloat16* h, const __nv_bfloat16* x,
                                          int rot, int r0, int rows, int k, int k0, int kw,
                                          int tid) {
  for (int i = tid; i < rot * rot; i += THREADS) h_s[i] = h[i];
#pragma unroll
  for (int j = 0; j < TR * TK / THREADS; ++j) {
    const int i = tid + j * THREADS, rr = i / TK, cc = i % TK, row = r0 + rr;
    x_s[rr][cc] = (row < rows && cc < kw) ? x[(long long)row * k + k0 + cc] : __float2bfloat16(0.f);
  }
}

// 0.5 * decoded scale, 0 for a NaN byte (a dead group)
__device__ __forceinline__ float half_scale(int byte) {
  const float s = qt::e4m3_decode(byte);
  return s != s ? 0.f : __fmul_rn(0.5f, s);
}

__global__ void __launch_bounds__(THREADS)
quantize_nv_int8_pass_a(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ h,
                        const float* __restrict__ gs_ptr, uint8_t* __restrict__ s,
                        float* __restrict__ vmax, int rows, int k, int rot, int method) {
  __shared__ __nv_bfloat16 h_s[128 * 128];
  __shared__ __nv_bfloat16 x_s[TR][TK];
  __shared__ int rmax_s[TR];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * TR, k0 = blockIdx.y * TK;
  const int kw = min(TK, k - k0);
  const float gs = *gs_ptr;

  load_tile(h_s, x_s, h, x, rot, r0, rows, k, k0, kw, tid);
  if (tid < TR) rmax_s[tid] = 0;
  __syncthreads();

  for (int p = warp; p < TR * 4; p += THREADS / 32) {
    const int rr = p >> 2, gg = p & 3, row = r0 + rr;
    if (row >= rows || gg * 32 >= kw) continue;  // warp-uniform
    const int col = gg * 32 + lane;
    const float v = qt::rotate_elem(x_s[rr], h_s, rot, col);
    const int byte = qt::nv_group_byte(v, method, gs);
    const float amax = qt::half_max(fabsf(v));
    const float m2 = (float)qt::e2m1_m2(qt::e2m1_code(__fmul_rn(amax, qt::nv_mul(byte, method, gs))));
    float c = col < kw ? __fmul_rn(m2, half_scale(byte)) : 0.f;
    c = fmaxf(c, __shfl_xor_sync(0xFFFFFFFFu, c, 16));
    if (lane == 0) atomicMax(&rmax_s[rr], __float_as_int(c));
    if ((lane & 15) == 0 && col < kw) s[(long long)((k0 + col) >> 4) * rows + row] = (uint8_t)byte;
  }
  __syncthreads();
  if (tid < TR && r0 + tid < rows) atomicMax(reinterpret_cast<int*>(vmax) + r0 + tid, rmax_s[tid]);
}

__global__ void __launch_bounds__(THREADS)
quantize_nv_int8_pass_b(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ h,
                        const float* __restrict__ gs_ptr, const uint8_t* __restrict__ s,
                        const float* __restrict__ vmax, int8_t* __restrict__ a,
                        float* __restrict__ sigma_out, int rows, int k, int rot, int method) {
  __shared__ __nv_bfloat16 h_s[128 * 128];
  __shared__ __nv_bfloat16 x_s[TR][TK];
  __shared__ int8_t a_s[TK][ASTRIDE];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * TR, k0 = blockIdx.y * TK;
  const int kw = min(TK, k - k0);
  const float gs = *gs_ptr;

  load_tile(h_s, x_s, h, x, rot, r0, rows, k, k0, kw, tid);
  __syncthreads();

  for (int p = warp; p < TR * 4; p += THREADS / 32) {
    const int rr = p >> 2, gg = p & 3, row = r0 + rr;
    if (row >= rows || gg * 32 >= kw) continue;
    const int col = gg * 32 + lane;
    if (col >= kw) continue;  // no shuffles below
    const float v = qt::rotate_elem(x_s[rr], h_s, rot, col);
    const int byte = s[(long long)((k0 + col) >> 4) * rows + row];
    const float m2 = (float)qt::e2m1_m2(qt::e2m1_code(__fmul_rn(v, qt::nv_mul(byte, method, gs))));
    const float sigma = __fmul_rn(vmax[row], kInv127);
    const float inv = sigma > 0.f ? __fdiv_rn(1.f, sigma) : 0.f;
    a_s[col][rr] = (int8_t)__float2int_rn(__fmul_rn(__fmul_rn(m2, half_scale(byte)), inv));
  }
  __syncthreads();
  for (int i = tid; i < TK * TR; i += THREADS) {
    const int kk = i / TR, rr = i % TR, row = r0 + rr;
    if (row < rows && kk < kw) a[(long long)(k0 + kk) * rows + row] = a_s[kk][rr];
  }
  if (blockIdx.y == 0 && tid < TR && r0 + tid < rows)
    sigma_out[r0 + tid] = __fmul_rn(vmax[r0 + tid], kInv127);
}

}  // namespace

// vmax: fp32 [rows] scratch, zeroed here before pass A
extern "C" int qt_quantize_nv_int8(const void* x, const void* h, const void* gs, void* a,
                                   void* sigma, void* s, void* vmax, int rows, int k, int rot,
                                   int method, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((rows + TR - 1) / TR, (k + TK - 1) / TK);
  cudaError_t err = cudaMemsetAsync(vmax, 0, sizeof(float) * (size_t)rows, st);
  if (err != cudaSuccess) return (int)err;
  quantize_nv_int8_pass_a<<<grid, THREADS, 0, st>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)h, (const float*)gs, (uint8_t*)s,
      (float*)vmax, rows, k, rot, method);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  quantize_nv_int8_pass_b<<<grid, THREADS, 0, st>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)h, (const float*)gs, (const uint8_t*)s,
      (const float*)vmax, (int8_t*)a, (float*)sigma, rows, k, rot, method);
  return (int)cudaGetLastError();
}
