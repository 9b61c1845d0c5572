// K2 quantize_mx_int8: fused rotation + MXFP4 quantization + int8 encode,
// the activation quantizer of every quantized linear.
//
// Replaces the Pallas kernels qutlass_tpu/kernels/quantize.py:
// fused_quantize_mx_int8 (bodies _quantize_mx_int8_oneshot_kernel :321
// and _quantize_mx_int8_kernel :403).  Outputs a' int8 [K, rows],
// row scale 2^(E-131) f32 [rows] and scale bytes u8 [K/32, rows], where
// E is the row's largest scale byte and a' = rtne(m2 * 2^(3 - (E - byte))).
//
// What bounds it on the H100: bytes and, at decode, parallelism.  Each
// row needs its largest scale byte over all of K before any a' can be
// written, so one block owns a block of rows and walks K twice.  Pass A
// computes and stores the scale bytes and the row maximum; pass B
// recomputes the rotation (cheaper than keeping it: `rot` FMAs per
// element against a round trip of 4 bytes) and emits a'.  Nothing
// carries between blocks, so no VMEM-style one-shot/revisit split exists
// here: one kernel covers every K.  With rows = batch = 4 at decode the
// grid is a single block, which is the first thing to fix.
#include "common.cuh"

namespace {

constexpr int TR = 8;        // rows per block
constexpr int TK = 128;      // columns per K step
constexpr int THREADS = 256;
constexpr int ASTRIDE = TR + 4;  // padded stride of the K-major a' tile

__device__ __forceinline__ void load_tile(__nv_bfloat16 (*x_s)[TK], const __nv_bfloat16* x,
                                          int r0, int rows, int k, int k0, int kw, int tid) {
#pragma unroll
  for (int j = 0; j < TR * TK / THREADS; ++j) {
    const int i = tid + j * THREADS, rr = i / TK, cc = i % TK, row = r0 + rr;
    x_s[rr][cc] = (row < rows && cc < kw) ? x[(long long)row * k + k0 + cc] : __float2bfloat16(0.f);
  }
}

__global__ void __launch_bounds__(THREADS)
quantize_mx_int8_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ h,
                        int8_t* __restrict__ a, float* __restrict__ sa, uint8_t* __restrict__ s,
                        int rows, int k, int rot, int method) {
  __shared__ __nv_bfloat16 h_s[128 * 128];
  __shared__ __nv_bfloat16 x_s[TR][TK];
  __shared__ int8_t a_s[TK][ASTRIDE];
  __shared__ int emax_s[TR];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * TR;

  for (int i = tid; i < rot * rot; i += THREADS) h_s[i] = h[i];
  if (tid < TR) emax_s[tid] = 0;

  // pass A: scale bytes and the row maximum
  for (int k0 = 0; k0 < k; k0 += TK) {
    const int kw = min(TK, k - k0);
    __syncthreads();  // previous tile fully consumed
    load_tile(x_s, x, r0, rows, k, k0, kw, tid);
    __syncthreads();
    for (int p = warp; p < TR * 4; p += THREADS / 32) {
      const int rr = p >> 2, gg = p & 3, row = r0 + rr;
      if (row >= rows || gg * 32 >= kw) continue;  // warp-uniform
      const float v = qt::rotate_elem(x_s[rr], h_s, rot, gg * 32 + lane);
      const int byte = qt::group_scale_byte(v, method);
      if (lane == 0) {
        s[(long long)((k0 >> 5) + gg) * rows + row] = (uint8_t)byte;
        atomicMax(&emax_s[rr], byte);
      }
    }
  }

  // pass B: recompute the rotation and emit a'
  for (int k0 = 0; k0 < k; k0 += TK) {
    const int kw = min(TK, k - k0);
    __syncthreads();  // emax_s final; previous a_s tile written out
    load_tile(x_s, x, r0, rows, k, k0, kw, tid);
    __syncthreads();
    for (int p = warp; p < TR * 4; p += THREADS / 32) {
      const int rr = p >> 2, gg = p & 3, row = r0 + rr;
      if (row >= rows || gg * 32 >= kw) continue;
      const int col = gg * 32 + lane;
      const float v = qt::rotate_elem(x_s[rr], h_s, rot, col);
      const int byte = qt::group_scale_byte(v, method);
      const int m2 = qt::e2m1_m2(qt::e2m1_code(qt::group_q(v, byte, method)));
      // m2 * 2^(3-d) is an fp32 multiply and an RTNE round, not a shift:
      // it is exact for deficits d <= 3 and rounds deeper ones
      const float f = qt::pow2_f32(3 - (emax_s[rr] - byte));
      a_s[col][rr] = (int8_t)__float2int_rn(__fmul_rn((float)m2, f));
    }
    __syncthreads();
    for (int i = tid; i < TK * TR; i += THREADS) {
      const int kk = i / TR, rr = i % TR, row = r0 + rr;
      if (row < rows && kk < kw) a[(long long)(k0 + kk) * rows + row] = a_s[kk][rr];
    }
  }

  if (tid < TR && r0 + tid < rows) sa[r0 + tid] = qt::pow2_f32(emax_s[tid] - 131);
}

}  // namespace

extern "C" int qt_quantize_mx_int8(const void* x, const void* h, void* a, void* sa, void* s,
                                   int rows, int k, int rot, int method, void* stream) {
  const dim3 grid((rows + TR - 1) / TR);
  quantize_mx_int8_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)h, (int8_t*)a, (float*)sa, (uint8_t*)s, rows,
      k, rot, method);
  return (int)cudaGetLastError();
}
