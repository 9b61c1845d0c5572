// K2 quantize_mx_int8: fused rotation + MXFP4 quantization + int8 encode,
// the activation quantizer of every MXFP4 linear with int8-stored weights
// (the main path).
//
// Replaces the Pallas kernels qutlass_tpu/kernels/quantize.py:
// fused_quantize_mx_int8 (bodies _quantize_mx_int8_oneshot_kernel :321
// and _quantize_mx_int8_kernel :403).  Outputs a' int8 [K, rows],
// row scale 2^(E-131) f32 [rows] and scale bytes u8 [K/32, rows], where
// E is the row's largest scale byte and a' = rtne(m2 * 2^(3 - (E - byte))).
//
// What bounds it on the H100: at decode (rows = 4) the launches and the
// number of SMs that get work, not bytes (K = 12288 moves under 0.2 MB);
// at prefill the bytes.  Each a' needs E over the whole row, which is
// what serialised the first design (one block walked all of K twice: one
// SM of 132 at decode).  Now (quantize_int8_tile.cuh) K is split over a
// grid of (row tiles) x (128-column chunks); pass A rotates with the
// rotation column in registers, writes the bytes and each element's m2
// into a', and folds the chunk's byte maximum into a scratch [rows] with
// an integer atomicMax; the encode launch scales m2 by 2^(3-d)
// elementwise and its last block zeroes the scratch for the next call.
// m2 * 2^(3-d) is an fp32 multiply and an RTNE round, not a shift: it is
// exact for deficits d <= 3 and rounds deeper ones, as the plain version.
#include "quantize_int8_tile.cuh"

namespace {

using namespace qi8;

// a' from the stored m2, the row maximum E and the group's byte
__device__ __forceinline__ int encode_mx(int m2, int emax, int byte) {
  return __float2int_rn(__fmul_rn((float)m2, qt::pow2_f32(3 - (emax - byte))));
}

template <int TR, int ROT>
__global__ void __launch_bounds__(THREADS)
quantize_mx_int8_pass_a(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ h,
                        int8_t* __restrict__ a, uint8_t* __restrict__ s, int* __restrict__ emax,
                        int rows, int k, int method) {
  __shared__ __align__(16) __nv_bfloat16 x_s[TR][TK];
  __shared__ int8_t a_s[TK][TR + 4];
  __shared__ uint8_t s_s[TK / 32][TR];
  __shared__ int emax_s[TR];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, gg = warp & 3;
  const int r0 = blockIdx.x * TR, k0 = blockIdx.y * TK;
  const int kw = min(TK, k - k0), nr = min(TR, rows - r0);
  const int col = gg * 32 + lane, hc = col % ROT;

  RotCol<ROT> hcol;
  hcol.load(h, hc);
  load_x_tile<TR>(x_s, x, r0, rows, k, k0, kw, tid);
  if (tid < TR) emax_s[tid] = 0;
  __syncthreads();

  if (gg * 32 < kw) {  // warp-uniform: K is a multiple of 32
#pragma unroll
    for (int j = 0; j < TR / 2; ++j) {
      const int rr = (warp >> 2) + 2 * j;
      if (rr < nr) {
        const float v = hcol.rotate(&x_s[rr][col - hc]);
        const int byte = qt::group_scale_byte(v, method);
        a_s[col][rr] = (int8_t)qt::e2m1_m2(qt::e2m1_code(qt::group_q(v, byte, method)));
        if (lane == 0) {
          s_s[gg][rr] = (uint8_t)byte;
          atomicMax(&emax_s[rr], byte);
        }
      }
    }
  }
  __syncthreads();
  store_a_tile<TR>(a, a_s, r0, nr, rows, k0, kw, tid);
  if (tid < (TK / 32) * TR) {
    const int g = tid / TR, rr = tid % TR;
    if (g * 32 < kw && rr < nr) s[(long long)((k0 >> 5) + g) * rows + r0 + rr] = s_s[g][rr];
  }
  if (tid < nr) atomicMax(emax + r0 + tid, emax_s[tid]);
}

// a' = rtne(m2 * 2^(3-d)) and the row scales; the last block to finish
// zeroes the row maxima and the counter (emax[rows]) for the next call
__global__ void __launch_bounds__(THREADS)
quantize_mx_int8_encode(int8_t* __restrict__ a, float* __restrict__ sa,
                        const uint8_t* __restrict__ s, int* __restrict__ emax, int rows, int k) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long nt = (long long)gridDim.x * THREADS;
  encode_flat(a, (long long)k * rows, rows, t, nt, [&](int m2, int kk, int r) {
    return encode_mx(m2, emax[r], __ldg(s + (long long)(kk >> 5) * rows + r));
  });
  for (long long r = t; r < rows; r += nt) sa[r] = qt::pow2_f32(emax[r] - 131);
  reset_when_last(emax, emax + rows, rows);
}

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* h;
  int8_t* a;
  float* sa;
  uint8_t* s;
  int* emax;
  int rows, k, method;
  cudaStream_t st;
};

template <int TR, int ROT>
struct PassA {
  static cudaError_t run(Args p) {
    const dim3 grid((p.rows + TR - 1) / TR, (p.k + TK - 1) / TK);
    quantize_mx_int8_pass_a<TR, ROT><<<grid, THREADS, 0, p.st>>>(p.x, p.h, p.a, p.s, p.emax,
                                                                  p.rows, p.k, p.method);
    return cudaGetLastError();
  }
};

}  // namespace

// scratch: int32 [rows + 1] that holds zeros (the row maxima, then the
// encode's arrival counter); the call leaves it zero.  Two launches.
extern "C" int qt_quantize_mx_int8(const void* x, const void* h, void* a, void* sa, void* s,
                                   void* scratch, int rows, int k, int rot, int method,
                                   void* stream) {
  const Args p{(const __nv_bfloat16*)x, (const __nv_bfloat16*)h, (int8_t*)a, (float*)sa,
               (uint8_t*)s, (int*)scratch, rows, k, method, (cudaStream_t)stream};
  const cudaError_t err = dispatch<PassA>(rows, rot, p);
  if (err != cudaSuccess) return (int)err;
  quantize_mx_int8_encode<<<encode_blocks(rows, k), THREADS, 0, p.st>>>(p.a, p.sa, p.s, p.emax,
                                                                        rows, k);
  return (int)cudaGetLastError();
}
