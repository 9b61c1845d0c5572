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
// What bounds it on the H100: at decode (rows = 4) the launches, at
// prefill the bytes.  The design is K2's (quantize_int8_tile.cuh): a grid
// of (row tiles) x (128-column chunks), the rotation column in registers,
// wide row tiles for the K-major stores, and a pass A that writes the
// bytes and each element's m2 into a' and folds the row maximum of |v|
// into a scratch [rows] with one atomicMax per row on the fp32 bits (the
// values are >= 0, so their bits order as integers; the maximum is exact
// and independent of the order of the blocks).  The encode launch
// forms v = m2 * 0.5 * s_g again and scales it; two launches a call, on a
// scratch that the encode's last block leaves zero.  The scale arithmetic is the plain version's, in its order,
// with __fmul_rn/__fdiv_rn/__fsqrt_rn.
#include "quantize_int8_tile.cuh"

namespace {

using namespace qi8;

constexpr float kInv127 = (float)(1.0 / 127.0);

// 0.5 * decoded scale, 0 for a NaN byte (a dead group)
__device__ __forceinline__ float half_scale(int byte) {
  const float s = qt::e4m3_decode(byte);
  return s != s ? 0.f : __fmul_rn(0.5f, s);
}

// 1 / sigma of a row from the bits of its largest |v| (0 for a zero row)
__device__ __forceinline__ float inv_sigma(int vmax_bits) {
  const float sigma = __fmul_rn(__int_as_float(vmax_bits), kInv127);
  return sigma > 0.f ? __fdiv_rn(1.f, sigma) : 0.f;
}

__device__ __forceinline__ int encode_nv(int m2, float inv, int byte) {
  return __float2int_rn(__fmul_rn(__fmul_rn((float)m2, half_scale(byte)), inv));
}

template <int TR, int ROT>
__global__ void __launch_bounds__(THREADS)
quantize_nv_int8_pass_a(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ h,
                        const float* __restrict__ gs_ptr, int8_t* __restrict__ a,
                        uint8_t* __restrict__ s, int* __restrict__ vmax, int rows, int k,
                        int method) {
  __shared__ __align__(16) __nv_bfloat16 x_s[TR][TK];
  __shared__ int8_t a_s[TK][TR + 4];
  __shared__ uint8_t s_s[TK / 16][TR];
  __shared__ int vmax_s[TR];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, gg = warp & 3;
  const int r0 = blockIdx.x * TR, k0 = blockIdx.y * TK;
  const int kw = min(TK, k - k0), nr = min(TR, rows - r0);
  const int col = gg * 32 + lane, hc = col % ROT;
  const float gs = *gs_ptr;

  RotCol<ROT> hcol;
  hcol.load(h, hc);
  load_x_tile<TR>(x_s, x, r0, rows, k, k0, kw, tid);
  if (tid < TR) vmax_s[tid] = 0;
  __syncthreads();

  if (gg * 32 < kw) {  // warp-uniform; a half warp past kw (K % 32 == 16) reads zeros
#pragma unroll
    for (int j = 0; j < TR / 2; ++j) {
      const int rr = (warp >> 2) + 2 * j;
      if (rr < nr) {
        const float v = hcol.rotate(&x_s[rr][col - hc]);
        const int byte = qt::nv_group_byte(v, method, gs);
        const int m2 = qt::e2m1_m2(qt::e2m1_code(__fmul_rn(v, qt::nv_mul(byte, method, gs))));
        a_s[col][rr] = (int8_t)m2;
        // |v| of the plain version, exact: |m2| <= 12 times 0.5 * s_g
        const float c = qt::warp_max(col < kw ? __fmul_rn(fabsf((float)m2), half_scale(byte)) : 0.f);
        if (lane == 0) atomicMax(&vmax_s[rr], __float_as_int(c));
        if ((lane & 15) == 0) s_s[col >> 4][rr] = (uint8_t)byte;
      }
    }
  }
  __syncthreads();
  store_a_tile<TR>(a, a_s, r0, nr, rows, k0, kw, tid);
  if (tid < (TK / 16) * TR) {
    const int g = tid / TR, rr = tid % TR;
    if (g * 16 < kw && rr < nr) s[(long long)((k0 >> 4) + g) * rows + r0 + rr] = s_s[g][rr];
  }
  if (tid < nr) atomicMax(vmax + r0 + tid, vmax_s[tid]);
}

// a' = rtne(m2 * 0.5 * s_g * (1 / sigma)) and sigma; the last block to
// finish zeroes the row maxima and the counter (vmax[rows]) for the next call
__global__ void __launch_bounds__(THREADS)
quantize_nv_int8_encode(int8_t* __restrict__ a, float* __restrict__ sigma,
                        const uint8_t* __restrict__ s, int* __restrict__ vmax, int rows, int k) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long nt = (long long)gridDim.x * THREADS;
  encode_flat(a, (long long)k * rows, rows, t, nt, [&](int m2, int kk, int r) {
    return encode_nv(m2, inv_sigma(vmax[r]), __ldg(s + (long long)(kk >> 4) * rows + r));
  });
  for (long long r = t; r < rows; r += nt) sigma[r] = __fmul_rn(__int_as_float(vmax[r]), kInv127);
  reset_when_last(vmax, vmax + rows, rows);
}

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* h;
  const float* gs;
  int8_t* a;
  float* sigma;
  uint8_t* s;
  int* vmax;
  int rows, k, method;
  cudaStream_t st;
};

template <int TR, int ROT>
struct PassA {
  static cudaError_t run(Args p) {
    const dim3 grid((p.rows + TR - 1) / TR, (p.k + TK - 1) / TK);
    quantize_nv_int8_pass_a<TR, ROT><<<grid, THREADS, 0, p.st>>>(p.x, p.h, p.gs, p.a, p.s, p.vmax,
                                                                  p.rows, p.k, p.method);
    return cudaGetLastError();
  }
};

}  // namespace

// scratch: int32 [rows + 1] that holds zeros (the fp32 bits of each row's
// largest |v|, then the encode's arrival counter); the call leaves it
// zero.  Two launches.
extern "C" int qt_quantize_nv_int8(const void* x, const void* h, const void* gs, void* a,
                                   void* sigma, void* s, void* scratch, int rows, int k, int rot,
                                   int method, void* stream) {
  const Args p{(const __nv_bfloat16*)x, (const __nv_bfloat16*)h, (const float*)gs, (int8_t*)a,
               (float*)sigma, (uint8_t*)s, (int*)scratch, rows, k, method,
               (cudaStream_t)stream};
  const cudaError_t err = dispatch<PassA>(rows, rot, p);
  if (err != cudaSuccess) return (int)err;
  quantize_nv_int8_encode<<<encode_blocks(rows, k), THREADS, 0, p.st>>>(p.a, p.sigma, p.s,
                                                                        p.vmax, rows, k);
  return (int)cudaGetLastError();
}
