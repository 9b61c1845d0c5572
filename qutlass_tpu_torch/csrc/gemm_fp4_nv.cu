// K7 gemm_fp4_nv: the NVFP4 GEMM,
//   C[m, n] = out( float(sum_k dq(a)[m, k] * dq(b)[n, k]) * alpha ),
// dq = e2m1 value times its 16-group e4m3 scale; out = bf16 or fp32.
//
// Replaces the Pallas kernel qutlass_tpu/kernels/gemm.py:193 _run_gemm
// with fmt="nv", behind matmul_nvf4_bf16_tn and matmul_nvf4_bf16_kmajor
// (:255/:265): the GEMM of NVFP4 linears with fp4-stored weights.
//
// Exactness, and what the design does about it.  An e4m3 scale is not a
// power of two, so the fp32 partial sums of a plain fp32 accumulation
// are not exact: over K = 4096 they would round, and a bf16 result would
// differ from the fp64 reference at a rate near 1e-3.  Instead, per
// 16-group, both kernels below take the exact sum of the 16 unscaled
// e2m1 products (multiples of 1/4 up to 36: 16 of them sum exactly in
// fp32), multiply it by the two scales (12 + 4 + 4 significant bits:
// exact), and add that into an fp64 accumulator.  Every group term is a
// multiple of 2^-20 and the fp64 sums stay exact while a row pair's group
// terms span fewer than ~40 binades; there the result, rounded once to
// fp32 and scaled by alpha, is bitwise the plain version's (fp64 sum of
// exact products, rounded once), and the order in which the terms are
// added does not change a bit.  Outside that regime no order is bitwise
// against the plain version, the tile kernel's included.
//
// The launcher picks one of two kernels:
//
// Decode (gemm_fp4_nv_decode): the K-major layout at M <= 16, the serving
// path's call (weight packed [K/2, N], scales [K/16, N]; activation [K/2,
// M] and [K/16, M]).  Bound by the weight bytes, 0.5625 byte an element
// (3.35 TB/s: 8.5 us at K x N = 4096 x 12288).  A block of 8 warps owns
// 32 C adjacent columns (C = 4, 2, 1 for M <= 4, 8, 16: the fp64
// accumulators, M C a thread, bound the columns) and one slice of K
// (split-K, so that even N = 1024 fills the SMs); its warps take the
// slice's 16-groups in turn.  A thread reads its C columns of each of a
// group's 8 byte rows and of its scale row with one load each, straight
// from device memory into registers, the next group's loads in flight
// while it multiplies, with no shared-memory slab and no barrier in the
// K loop.  The block's slice of the activation is staged once in shared
// memory as doubled e2m1 values (int8 m2) and decoded scales.  The group
// sum is taken in integers: the weight's codes become m2 bytes by three
// byte permutes against tables, __dp4a multiplies four k at a time, and
// the int sum times 0.25 is the same exact fp32 value as the tile
// kernel's fp32 sum.  Each block adds its warps' fp64 sums in warp order
// and writes them to a workspace the wrapper allocates; the last block of
// a column tile to arrive (a per-tile counter, which it resets) adds the
// splits in order, rounds once to fp32 and multiplies by alpha, in one
// launch and with no host sync.  The row-major (tn) layout at M <= 16
// stays on the tile kernel.
//
// Tile (gemm_fp4_nv_kernel): every other call.  64x64 outputs, 256
// threads of 4x4 outputs each (the tile of gemm_fp4_tile.cuh, shared with
// K17).  Every K step of 32 (two scale groups) decodes a 32x64 slab of
// each operand into shared memory as fp32 e2m1 values, plus the slab's
// scales.  Operands and scales are read through strides, so the
// row-major and K-major layouts share the kernel.  At prefill it is bound
// by the CUDA cores' fp32 rate, since it does not use the tensor cores.
//
// alpha is read from device memory by both kernels.
#include "gemm_fp4_tile.cuh"

namespace {

using namespace qt::tile;
constexpr int BK = 32;  // two scale groups

template <typename Out>
__global__ void __launch_bounds__(THREADS)
gemm_fp4_nv_kernel(const uint8_t* __restrict__ a, long long a_m, long long a_k,
                   const uint8_t* __restrict__ as, long long as_m, long long as_g,
                   const uint8_t* __restrict__ b, long long b_n, long long b_k,
                   const uint8_t* __restrict__ bs, long long bs_n, long long bs_g,
                   const float* __restrict__ alpha_ptr, Out* __restrict__ c, int M, int N, int K) {
  __shared__ float As[BK][PAD];
  __shared__ float Bs[BK][PAD];
  __shared__ float Sa[BK / 16][BM];
  __shared__ float Sb[BK / 16][BN];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  double acc[4][4];
  zero(acc);
  for (int k0 = 0; k0 < K; k0 += BK) {
    decode_nv<BK>(As, Sa, a, a_m, a_k, as, as_m, as_g, m0, M, k0, K, tid);
    decode_nv<BK>(Bs, Sb, b, b_n, b_k, bs, bs_n, bs_g, n0, N, k0, K, tid);
    __syncthreads();
#pragma unroll
    for (int g = 0; g < BK / 16; ++g) nv_accumulate_group(acc, As, Bs, Sa, Sb, g, tx, ty);
    __syncthreads();
  }
  store(c, acc, *alpha_ptr, m0, n0, M, N, tx, ty);
}

// ---------------------------------------------------------------------------
// decode: M <= 16, K-major, split-K, the weight streamed into registers
// ---------------------------------------------------------------------------

namespace dec {
constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int KC_GRAN = 16 * WARPS;  // a slice is a whole number of groups per warp
constexpr int MAX_KC = 2048;
constexpr int DEPTH = 2;  // groups whose loads are in flight while one is multiplied
constexpr int COLS4 = 4;  // columns a thread owns at M <= 4
// columns a thread owns at row bucket mb (mb x cols fp64 accumulators)
__host__ __device__ constexpr int cols(int mb) { return mb == 4 ? COLS4 : 16 / mb; }
__host__ __device__ constexpr int tile(int mb) { return 32 * cols(mb); }
// the staged slice: int8 m2 [mb][kc], the scale pairs {sa / 4, -MAGIC sa / 4}
// as double2 [mb][kc / 16], the e4m3 table double [256]; after the K loop
// the first 32 KB hold the warps' fp64 sums [WARPS][16][32]
__host__ __device__ constexpr size_t act_bytes(int mb, int kc) { return (size_t)mb * kc; }
__host__ __device__ constexpr size_t sc_bytes(int mb, int kc) { return (size_t)mb * kc; }
__host__ __device__ constexpr size_t smem(int mb, int kc) {
  return act_bytes(mb, kc) + sc_bytes(mb, kc) + 256 * 8 > (size_t)WARPS * 16 * 32 * 8
             ? act_bytes(mb, kc) + sc_bytes(mb, kc) + 256 * 8
             : (size_t)WARPS * 16 * 32 * 8;
}
// 2^52 + 2^51 + 2^31: the double whose low word is s + 2^31 is MAGIC + s
constexpr double MAGIC = 6755401588539392.0;
}  // namespace dec

// C bytes at p (C adjacent columns of one byte row), byte j in bits 8j:
// one aligned load (VEC: the host checked the base, the row stride and N
// against C), else byte loads, zero beyond `valid` columns
template <int C, bool VEC>
__device__ __forceinline__ uint32_t load_cols(const uint8_t* __restrict__ p, int valid) {
  if constexpr (VEC) {
    if (valid <= 0) return 0;
    if constexpr (C == 4) return __ldg(reinterpret_cast<const unsigned int*>(p));
    if constexpr (C == 2) return __ldg(reinterpret_cast<const unsigned short*>(p));
    return __ldg(p);
  }
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < C; ++j)
    if (j < valid) v |= (uint32_t)__ldg(p + j) << (8 * j);
  return v;
}

// the four e2m1 codes in x's low 16 bits (nibble i: k + i) -> their
// doubled values m2 as four signed bytes (byte i: k + i): the magnitudes
// index both tables, and each code's sign bit picks the negated table in
// the last permute
__device__ __forceinline__ uint32_t m2x4(uint32_t x) {
  constexpr uint32_t P0 = 0x03020100u, P1 = 0x0C080604u;  // m2 of magnitudes 0..7
  constexpr uint32_t N0 = 0xFDFEFF00u, N1 = 0xF4F8FAFCu;  // their negations
  const uint32_t mag = x & 0x7777u;
  const uint32_t pos = __byte_perm(P0, P1, mag);
  const uint32_t neg = __byte_perm(N0, N1, mag);
  return __byte_perm(pos, neg, ((x >> 1) & 0x4444u) | 0x3210u);
}

// one 16-group: w[r] holds byte row 8g + r (k = 16g + 2r low nibble, + 1
// high) of the thread's C columns, w[8] their scale bytes; act_g the
// group's m2 of row m at act_g + m * kc (16 bytes, k ascending), sc_g its
// scale pair at sc_g[m * gpr], tab the e4m3 bytes' values.  s, the int
// sum of 16 m2 products, is 4 p with p the tile kernel's exact group sum;
// MAGIC + s is formed from bits, and fma(MAGIC + s, sa / 4, -MAGIC sa / 4)
// = p sa exactly (one rounding of an exact value), so the term added,
// fma(p sa, sb, acc), is acc + the tile kernel's exact term, rounded once
template <int MB, int C>
__device__ __forceinline__ void nv_group(double (&acc)[MB][C], const uint32_t (&w)[9],
                                         const int8_t* act_g, int kc, const double2* sc_g,
                                         int gpr, const double* tab) {
  uint32_t wv[C][4];  // column j's m2 of k = 4rp..4rp+3, from byte rows 2rp and 2rp + 1
  double sb[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
#pragma unroll
    for (int rp = 0; rp < 4; ++rp)
      wv[j][rp] = m2x4(__byte_perm(w[2 * rp], w[2 * rp + 1], j | ((4 + j) << 4)));
    sb[j] = tab[(w[8] >> (8 * j)) & 0xFF];
  }
#pragma unroll
  for (int m = 0; m < MB; ++m) {
    const uint4 av = *reinterpret_cast<const uint4*>(act_g + m * kc);
    const double2 sc = sc_g[m * gpr];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      int s = __dp4a((int)av.x, (int)wv[j][0], 0);
      s = __dp4a((int)av.y, (int)wv[j][1], s);
      s = __dp4a((int)av.z, (int)wv[j][2], s);
      s = __dp4a((int)av.w, (int)wv[j][3], s);
      const double d = __hiloint2double(0x43380000, s ^ (int)0x80000000);  // MAGIC + s
      acc[m][j] = fma(fma(d, sc.x, sc.y), sb[j], acc[m][j]);                // exact term
    }
  }
}

template <int MB, bool VEC, typename Out>
__global__ void __launch_bounds__(dec::THREADS, 2)
gemm_fp4_nv_decode(const uint8_t* __restrict__ a, long long a_m, long long a_k,
                   const uint8_t* __restrict__ as, long long as_m, long long as_g,
                   const uint8_t* __restrict__ b, long long b_k,
                   const uint8_t* __restrict__ bs, long long bs_g,
                   const float* __restrict__ alpha_ptr, Out* __restrict__ c, int M, int N, int K,
                   int kc, double* __restrict__ part, int* __restrict__ counters) {
  constexpr int C = dec::cols(MB), W = dec::tile(MB);
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* act = reinterpret_cast<int8_t*>(smem);                                  // [MB][kc]
  double2* sc_s = reinterpret_cast<double2*>(smem + dec::act_bytes(MB, kc));     // [MB][kc/16]
  double* tab = reinterpret_cast<double*>(smem + dec::act_bytes(MB, kc) + dec::sc_bytes(MB, kc));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * W, split = blockIdx.y, splits = gridDim.y;
  const int kbeg = split * kc, kend = min(K, kbeg + kc);
  const int gbeg = kbeg >> 4, gend = kend >> 4, gpr = kc >> 4;
  const int valid = N - (n0 + lane * C);
  const uint8_t* bp = b + n0 + lane * C;
  const uint8_t* sp = bs + n0 + lane * C;

  constexpr int D = dec::DEPTH, WS = dec::WARPS;
  uint32_t buf[D + 1][9];  // a ring of groups' weight bytes
  auto fetch = [&](uint32_t (&f)[9], int g) {
    const uint8_t* row = bp + (long long)(8 * g) * b_k;
#pragma unroll
    for (int r = 0; r < 8; ++r, row += b_k) f[r] = load_cols<C, VEC>(row, valid);
    f[8] = load_cols<C, VEC>(sp + (long long)g * bs_g, valid);
  };
  int g = gbeg + warp;
#pragma unroll
  for (int u = 0; u < D; ++u)  // in flight while the activation is staged
    if (g + u * WS < gend) fetch(buf[u], g + u * WS);

  // the slice's activation: m2 bytes of k = 2kp, 2kp + 1 per packed byte,
  // the scale pairs and the e4m3 table; rows M..MB-1 and k beyond the
  // slice are zero
  const int nkp = (kend - kbeg) >> 1;
  for (int i0 = tid; i0 < MB * (kc >> 1); i0 += 4 * dec::THREADS) {
    int byte[4];  // four loads in flight, then their stores
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * dec::THREADS, m = i % MB, kp = i / MB;
      byte[u] = (m < M && kp < nkp) ? a[(long long)m * a_m + (long long)((kbeg >> 1) + kp) * a_k] : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * dec::THREADS, m = i % MB, kp = i / MB;
      if (i < MB * (kc >> 1))
        *reinterpret_cast<unsigned short*>(act + m * kc + 2 * kp) =
            (unsigned short)((qt::e2m1_m2(byte[u] & 0xF) & 0xFF) |
                             ((qt::e2m1_m2(byte[u] >> 4) & 0xFF) << 8));
    }
  }
  for (int i = tid; i < MB * gpr; i += dec::THREADS) {
    const int m = i % MB, gg = i / MB;
    const double sa =
        (m < M && gg < gend - gbeg)
            ? 0.25 * (double)qt::e4m3_decode(as[(long long)m * as_m + (long long)(gbeg + gg) * as_g])
            : 0.0;
    sc_s[m * gpr + gg] = make_double2(sa, -dec::MAGIC * sa);  // both exact
  }
  tab[tid] = (double)qt::e4m3_decode(tid);  // THREADS == 256
  __syncthreads();

  double acc[MB][C];
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[m][j] = 0.0;
  // buffer u holds group g + u WS; each step refills the buffer freed last
  for (; g < gend; g += (D + 1) * WS) {
#pragma unroll
    for (int u = 0; u <= D; ++u) {
      const int gu = g + u * WS;
      if (gu >= gend) break;
      if (gu + D * WS < gend) fetch(buf[(u + D) % (D + 1)], gu + D * WS);
      nv_group<MB, C>(acc, buf[u], act + (gu - gbeg) * 16, kc, sc_s + (gu - gbeg), gpr, tab);
    }
  }

  // the warps' sums, added in warp order: the block's fp64 partial of
  // (split, m, n), written to part[split][m][n]
  __syncthreads();  // every warp is done with the staged slice
  double* red = reinterpret_cast<double*>(smem);  // [WARPS][MB * C][32]
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int j = 0; j < C; ++j) red[(warp * MB * C + m * C + j) * 32 + lane] = acc[m][j];
  __syncthreads();
  for (int o = tid; o < MB * W; o += dec::THREADS) {
    const int m = o / W, col = o % W, n = n0 + col;
    if (m < M && n < N) {
      double s = 0.0;
#pragma unroll
      for (int w = 0; w < dec::WARPS; ++w) s += red[(w * MB * C + m * C + col % C) * 32 + col / C];
      part[((long long)split * M + m) * N + n] = s;
    }
  }
  __threadfence();
  __syncthreads();
  __shared__ int last;
  if (tid == 0) last = atomicAdd(&counters[blockIdx.x], 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float alpha = *alpha_ptr;
  for (int o = tid; o < MB * W; o += dec::THREADS) {
    const int m = o / W, n = n0 + o % W;
    if (m < M && n < N) {
      double s = 0.0;
      for (int sp = 0; sp < splits; ++sp) s += __ldcg(part + ((long long)sp * M + m) * N + n);
      out(c, (long long)m * N + n, __fmul_rn(__double2float_rn(s), alpha));
    }
  }
  if (tid == 0) counters[blockIdx.x] = 0;  // ready for the next launch (and graph replay)
}

constexpr int kMaxDev = 64;

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

template <int MB, bool VEC, typename Out>
int launch_decode(const uint8_t* a, long long a_m, long long a_k, const uint8_t* as, long long as_m,
                  long long as_g, const uint8_t* b, long long b_k, const uint8_t* bs,
                  long long bs_g, const float* alpha, Out* c, int M, int N, int K, int kc,
                  double* part, int* counters, cudaStream_t st) {
  static bool done[kMaxDev] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDev || !done[dev]) {  // the largest slice's shared memory, once a device
    err = cudaFuncSetAttribute(gemm_fp4_nv_decode<MB, VEC, Out>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dec::smem(MB, dec::MAX_KC));
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDev) done[dev] = true;
  }
  const dim3 grid((N + dec::tile(MB) - 1) / dec::tile(MB), (K + kc - 1) / kc);
  gemm_fp4_nv_decode<MB, VEC, Out><<<grid, dec::THREADS, dec::smem(MB, kc), st>>>(
      a, a_m, a_k, as, as_m, as_g, b, b_k, bs, bs_g, alpha, c, M, N, K, kc, part, counters);
  return (int)cudaGetLastError();
}

template <int MB, typename Out>
int launch_decode_vec(const uint8_t* a, long long a_m, long long a_k, const uint8_t* as,
                      long long as_m, long long as_g, const uint8_t* b, long long b_k,
                      const uint8_t* bs, long long bs_g, const float* alpha, Out* c, int M, int N,
                      int K, int kc, double* part, int* counters, cudaStream_t st) {
  constexpr int C = dec::cols(MB);
  if (aligned(b, C) && b_k % C == 0 && aligned(bs, C) && bs_g % C == 0 && N % C == 0)
    return launch_decode<MB, true>(a, a_m, a_k, as, as_m, as_g, b, b_k, bs, bs_g, alpha, c, M, N,
                                   K, kc, part, counters, st);
  return launch_decode<MB, false>(a, a_m, a_k, as, as_m, as_g, b, b_k, bs, bs_g, alpha, c, M, N, K,
                                  kc, part, counters, st);
}

template <typename Out>
int launch_decode_rows(const uint8_t* a, long long a_m, long long a_k, const uint8_t* as,
                       long long as_m, long long as_g, const uint8_t* b, long long b_k,
                       const uint8_t* bs, long long bs_g, const float* alpha, Out* c, int M, int N,
                       int K, int kc, double* part, int* counters, cudaStream_t st) {
  if (M <= 4)
    return launch_decode_vec<4>(a, a_m, a_k, as, as_m, as_g, b, b_k, bs, bs_g, alpha, c, M, N, K,
                                kc, part, counters, st);
  if (M <= 8)
    return launch_decode_vec<8>(a, a_m, a_k, as, as_m, as_g, b, b_k, bs, bs_g, alpha, c, M, N, K,
                                kc, part, counters, st);
  return launch_decode_vec<16>(a, a_m, a_k, as, as_m, as_g, b, b_k, bs, bs_g, alpha, c, M, N, K,
                               kc, part, counters, st);
}

}  // namespace

// a'[m, kp] = a[m * a_m + kp * a_k] (packed, kp = k / 2), a's scales
// as[m * as_m + g * as_g]; likewise b' [N, K/2] and bs; alpha fp32 on the
// device; c [M, N] bf16 or (out_f32) fp32.  With part == nullptr the tile
// kernel runs, on any strides.  With part, the decode kernel: M <= 16,
// K % 16 == 0, b and bs K-major (b_n == bs_n == 1), kc a multiple of 128
// and at most 2048; part fp64 [ceil(K / kc), M, N] and counters int32
// [ceil(N / (32 * (16 / MB)))] all zero (the kernel leaves them zero), MB
// = 4, 8 or 16, the least that holds M.  What the decode kernel does not
// take returns cudaErrorInvalidValue.
extern "C" int qt_gemm_fp4_nv(const void* a, long long a_m, long long a_k, const void* as,
                              long long as_m, long long as_g, const void* b, long long b_n,
                              long long b_k, const void* bs, long long bs_n, long long bs_g,
                              const void* alpha, void* c, int out_f32, int M, int N, int K,
                              void* part, void* counters, int kc, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const uint8_t *ap = (const uint8_t*)a, *asp = (const uint8_t*)as;
  const uint8_t *bp = (const uint8_t*)b, *bsp = (const uint8_t*)bs;
  const float* al = (const float*)alpha;
  if (part != nullptr) {
    if (M <= 0 || M > 16 || N <= 0 || K <= 0 || K % 16 || b_n != 1 || bs_n != 1 ||
        counters == nullptr || kc <= 0 || kc % dec::KC_GRAN || kc > dec::MAX_KC)
      return (int)cudaErrorInvalidValue;
    double* pp = (double*)part;
    int* cp = (int*)counters;
    if (out_f32)
      return launch_decode_rows<float>(ap, a_m, a_k, asp, as_m, as_g, bp, b_k, bsp, bs_g, al,
                                       (float*)c, M, N, K, kc, pp, cp, st);
    return launch_decode_rows<__nv_bfloat16>(ap, a_m, a_k, asp, as_m, as_g, bp, b_k, bsp, bs_g, al,
                                             (__nv_bfloat16*)c, M, N, K, kc, pp, cp, st);
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (out_f32)
    gemm_fp4_nv_kernel<float><<<grid, THREADS, 0, st>>>(
        ap, a_m, a_k, asp, as_m, as_g, bp, b_n, b_k, bsp, bs_n, bs_g, al, (float*)c, M, N, K);
  else
    gemm_fp4_nv_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        ap, a_m, a_k, asp, as_m, as_g, bp, b_n, b_k, bsp, bs_n, bs_g, al, (__nv_bfloat16*)c, M, N,
        K);
  return (int)cudaGetLastError();
}
