// K18 gemm_fp4_experts: the grouped MXFP4 GEMM of a dropless expert layer's
// decode step, every expert of one projection in one launch:
//   C[r, n] = out( float(sum_g p_g sa_g sb_g) * alpha ),
// for the output rows r of expert e, [offsets[e], offsets[e + 1]): the
// activation column rows[r] (r itself without rows) against expert e's
// weight, p_g a 32-group's exact sum of e2m1 products, sa_g and sb_g its
// two e8m0 scales.  Each output row is bitwise K4 (gemm_fp4_mx.cu) on that
// row against that expert's weight: the same exact group terms (dec::Mx,
// gemm_fp4_decode.cuh), folded in fp64, rounded once to fp32, times alpha.
//
// Layout: the activation packed [K/2, Ma] and its scales [K/32, Ma], any
// strides (K1's K-major output, quantized once for every expert); the
// experts' weights packed [E, K/2, N] and scales [E, K/32, N], unit stride
// along N; offsets int32 [E + 1] and rows int32 [R] in device memory, read
// on the card, so the launch is graph-safe and needs no host sync.
//
// Grid: (column tiles, E).  A block of 8 warps owns 32 C columns (C = 4,
// 2, 1 for a row tile MB = 4, 8, 16) of one expert.  An expert with no row
// exits at once, so a launch reads only the routed experts' weights, each
// once where its rows fit one row tile.  Given a routing counter, an
// expert's first column block adds its row count and 1 to the expert's two
// entries: one writer each, no atomics, no launch of its own.  Otherwise
// the block takes its expert's rows MB at a time, and each row tile walks
// K in slices of at most dec::MAX_KC: the slice's activation rows are
// staged in shared memory as int8 m2 and scale pairs, as in K4's decode
// kernel, while each thread streams its columns of the weight's byte rows
// into registers (the warps take the slice's groups in turn), and a
// group's term skips the rows the tile does not have.  No workspace, no split over K: the grid's
// experts fill the SMs.  The warps' fp64 sums are added in warp order;
// while a row's group terms span fewer than ~40 binades every fp64 sum is
// exact, so any order, K4's split-K one included, gives the same bits.
#include "gemm_fp4_decode.cuh"

namespace {
namespace xp {

using dec::THREADS;
using dec::WARPS;
using F = dec::Mx;
constexpr int G = F::G, R = G / 2;

// dec::group for the tile's first `mrows` rows (a uniform branch)
template <int MB, int C>
__device__ __forceinline__ void group(double (&acc)[MB][C], const uint32_t (&w)[R + 1],
                                      const int8_t* act_g, int kc, const double2* sc_g, int gpr,
                                      const double* tab, int mrows) {
  constexpr int Q = G / 4;
  uint32_t wv[C][Q];
  double sb[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
#pragma unroll
    for (int rp = 0; rp < Q; ++rp)
      wv[j][rp] = dec::m2x4(__byte_perm(w[2 * rp], w[2 * rp + 1], j | ((4 + j) << 4)));
    sb[j] = tab[(w[R] >> (8 * j)) & 0xFF];
  }
#pragma unroll
  for (int m = 0; m < MB; ++m) {
    if (m >= mrows) break;
    uint4 av[Q / 4];
#pragma unroll
    for (int h = 0; h < Q / 4; ++h) av[h] = reinterpret_cast<const uint4*>(act_g + m * kc)[h];
    const double2 sc = sc_g[m * gpr];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      int s = 0;
#pragma unroll
      for (int h = 0; h < Q / 4; ++h) {
        s = __dp4a((int)av[h].x, (int)wv[j][4 * h], s);
        s = __dp4a((int)av[h].y, (int)wv[j][4 * h + 1], s);
        s = __dp4a((int)av[h].z, (int)wv[j][4 * h + 2], s);
        s = __dp4a((int)av[h].w, (int)wv[j][4 * h + 3], s);
      }
      const double d = __hiloint2double(0x43380000, s ^ (int)0x80000000);  // MAGIC + s
      acc[m][j] = fma(fma(d, sc.x, sc.y), sb[j], acc[m][j]);                // exact term
    }
  }
}

template <int MB, bool VEC, typename Out>
__global__ void __launch_bounds__(THREADS, 2)
gemm_fp4_experts(const uint8_t* __restrict__ a, long long a_m, long long a_k,
                 const uint8_t* __restrict__ as, long long as_m, long long as_g,
                 const int* __restrict__ rows, const int* __restrict__ offsets,
                 const uint8_t* __restrict__ b, long long b_e, long long b_k,
                 const uint8_t* __restrict__ bs, long long bs_e, long long bs_g,
                 const float* __restrict__ alpha_ptr, float alpha_val, Out* __restrict__ c,
                 long long* __restrict__ counts, int N, int K, int kc) {
  constexpr int C = dec::cols(MB), W = dec::tile(MB), D = F::depth;
  const int e = blockIdx.y;
  const int beg = offsets[e], end = offsets[e + 1];
  if (beg >= end) return;  // no row routed to this expert: its weight is not read
  if (counts != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    counts[e] += end - beg;      // rows routed to expert e
    counts[gridDim.y + e] += 1;  // calls in which it got a row
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* act = reinterpret_cast<int8_t*>(smem_raw);                               // [MB][kc]
  double2* sc_s = reinterpret_cast<double2*>(smem_raw + dec::act_bytes(MB, kc));  // [MB][kc/G]
  double* tab =
      reinterpret_cast<double*>(smem_raw + dec::act_bytes(MB, kc) + dec::sc_bytes(MB, kc, G));
  double* red = reinterpret_cast<double*>(smem_raw);  // [WARPS][MB * C][32], after the K loop
  __shared__ long long arow[MB];                      // the tile's activation columns
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * W, gpr = kc / G;
  const int valid = N - (n0 + lane * C);
  const uint8_t* bp = b + (long long)e * b_e + n0 + lane * C;
  const uint8_t* sp = bs + (long long)e * bs_e + n0 + lane * C;
  const float alpha = alpha_ptr != nullptr ? *alpha_ptr : alpha_val;

  uint32_t buf[D + 1][R + 1];  // a ring of groups' weight bytes
  auto fetch = [&](uint32_t (&f)[R + 1], int g) {
    const uint8_t* row = bp + (long long)(R * g) * b_k;
#pragma unroll
    for (int r = 0; r < R; ++r, row += b_k) f[r] = dec::load_cols<C, VEC>(row, valid);
    f[R] = dec::load_cols<C, VEC>(sp + (long long)g * bs_g, valid);
  };

  for (int m0 = beg; m0 < end; m0 += MB) {  // the expert's rows, a tile at a time
    const int mrows = min(MB, end - m0);
    double acc[MB][C];
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int j = 0; j < C; ++j) acc[m][j] = 0.0;
    for (int kbeg = 0; kbeg < K; kbeg += kc) {
      const int kend = min(K, kbeg + kc), gbeg = kbeg / G, gend = kend / G;
      int g = gbeg + warp;
#pragma unroll
      for (int u = 0; u < D; ++u)  // in flight while the activation is staged
        if (g + u * WARPS < gend) fetch(buf[u], g + u * WARPS);
      __syncthreads();  // the previous slice's or tile's readers of shared memory are done
      if (tid < MB)
        arow[tid] = tid < mrows ? (rows != nullptr ? rows[m0 + tid] : m0 + tid) : 0;
      __syncthreads();
      // the slice's activation as in dec::gemm_fp4_decode; rows from
      // mrows on and k beyond the slice are zero
      const int nkp = (kend - kbeg) >> 1;
      for (int i0 = tid; i0 < MB * (kc >> 1); i0 += 4 * THREADS) {
        int byte[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u * THREADS, m = i % MB, kp = i / MB;
          byte[u] = (m < mrows && kp < nkp)
                        ? a[arow[m] * a_m + (long long)((kbeg >> 1) + kp) * a_k]
                        : 0;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u * THREADS, m = i % MB, kp = i / MB;
          if (i < MB * (kc >> 1))
            *reinterpret_cast<unsigned short*>(act + m * kc + 2 * kp) =
                (unsigned short)((qt::e2m1_m2(byte[u] & 0xF) & 0xFF) |
                                 ((qt::e2m1_m2(byte[u] >> 4) & 0xFF) << 8));
        }
      }
      for (int i = tid; i < MB * gpr; i += THREADS) {
        const int m = i % MB, gg = i / MB;
        const double sa = (m < mrows && gg < gend - gbeg)
                              ? 0.25 * F::scale(as[arow[m] * as_m + (long long)(gbeg + gg) * as_g])
                              : 0.0;
        sc_s[m * gpr + gg] = make_double2(sa, -dec::MAGIC * sa);  // both exact
      }
      tab[tid] = F::scale(tid);  // THREADS == 256
      __syncthreads();
      // buffer u holds group g + u WARPS; each step refills the buffer freed last
      for (; g < gend; g += (D + 1) * WARPS) {
#pragma unroll
        for (int u = 0; u <= D; ++u) {
          const int gu = g + u * WARPS;
          if (gu >= gend) break;
          if (gu + D * WARPS < gend) fetch(buf[(u + D) % (D + 1)], gu + D * WARPS);
          group<MB, C>(acc, buf[u], act + (gu - gbeg) * G, kc, sc_s + (gu - gbeg), gpr, tab, mrows);
        }
      }
    }
    // the warps' sums, added in warp order, rounded once to fp32, times alpha
    __syncthreads();
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int j = 0; j < C; ++j) red[(warp * MB * C + m * C + j) * 32 + lane] = acc[m][j];
    __syncthreads();
    for (int o = tid; o < MB * W; o += THREADS) {
      const int m = o / W, col = o % W, n = n0 + col;
      if (m < mrows && n < N) {
        double s = 0.0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) s += red[(w * MB * C + m * C + col % C) * 32 + col / C];
        qt::tile::out(c, (long long)(m0 + m) * N + n, __fmul_rn(__double2float_rn(s), alpha));
      }
    }
  }
}

constexpr int kMaxDev = 64;

template <int MB, bool VEC, typename Out>
int launch(const uint8_t* a, long long a_m, long long a_k, const uint8_t* as, long long as_m,
           long long as_g, const int* rows, const int* offsets, int E, const uint8_t* b,
           long long b_e, long long b_k, const uint8_t* bs, long long bs_e, long long bs_g,
           const float* alpha, float alpha_val, Out* c, long long* counts, int N, int K, int kc,
           cudaStream_t st) {
  static bool done[kMaxDev] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDev || !done[dev]) {  // the largest slice's shared memory, once a device
    err = cudaFuncSetAttribute(gemm_fp4_experts<MB, VEC, Out>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dec::smem(MB, dec::MAX_KC, G));
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDev) done[dev] = true;
  }
  const dim3 grid((N + dec::tile(MB) - 1) / dec::tile(MB), E);
  gemm_fp4_experts<MB, VEC, Out><<<grid, THREADS, dec::smem(MB, kc, G), st>>>(
      a, a_m, a_k, as, as_m, as_g, rows, offsets, b, b_e, b_k, bs, bs_e, bs_g, alpha, alpha_val,
      c, counts, N, K, kc);
  return (int)cudaGetLastError();
}

template <int MB, typename Out>
int launch_vec(const uint8_t* a, long long a_m, long long a_k, const uint8_t* as,
               long long as_m, long long as_g, const int* rows, const int* offsets, int E,
               const uint8_t* b, long long b_e, long long b_k, const uint8_t* bs, long long bs_e,
               long long bs_g, const float* alpha, float alpha_val, Out* c, long long* counts,
               int N, int K, int kc, cudaStream_t st) {
  constexpr int C = dec::cols(MB);
  if (dec::aligned(b, C) && b_e % C == 0 && b_k % C == 0 && dec::aligned(bs, C) &&
      bs_e % C == 0 && bs_g % C == 0 && N % C == 0)
    return launch<MB, true>(a, a_m, a_k, as, as_m, as_g, rows, offsets, E, b, b_e, b_k, bs, bs_e,
                            bs_g, alpha, alpha_val, c, counts, N, K, kc, st);
  return launch<MB, false>(a, a_m, a_k, as, as_m, as_g, rows, offsets, E, b, b_e, b_k, bs, bs_e,
                           bs_g, alpha, alpha_val, c, counts, N, K, kc, st);
}

}  // namespace xp
}  // namespace

// a'[m, kp] = a[m * a_m + kp * a_k] (packed, kp = k / 2) with scales
// as[m * as_m + g * as_g]; rows int32 [R] (null: output row r reads
// activation column r) and offsets int32 [E + 1] on the device; expert e's
// weight b[e * b_e + kp * b_k + n] with scales bs[e * bs_e + g * bs_g + n];
// alpha fp32 on the device, or alpha_val where alpha is null; c [R, N] bf16
// or (out_f32) fp32.  max_rows bounds an expert's rows (the row tile MB = 4,
// 8 or 16, the least that holds it; more rows are taken in turns); K % 32
// == 0.  counts int64 [2, E] on the device, or null: the routing counter,
// counts[0][e] += expert e's rows and counts[1][e] += 1 where it has any.
// What it does not take returns cudaErrorInvalidValue.
extern "C" int qt_gemm_fp4_experts(const void* a, long long a_m, long long a_k, const void* as,
                                   long long as_m, long long as_g, const void* rows,
                                   const void* offsets, int E, const void* b, long long b_e,
                                   long long b_k, const void* bs, long long bs_e, long long bs_g,
                                   const void* alpha, float alpha_val, void* c, int out_f32,
                                   void* counts, int max_rows, int N, int K, void* stream) {
  if (E <= 0 || N <= 0 || K <= 0 || K % 32 || max_rows <= 0 || offsets == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const uint8_t *ap = (const uint8_t*)a, *asp = (const uint8_t*)as;
  const uint8_t *bp = (const uint8_t*)b, *bsp = (const uint8_t*)bs;
  const int *rp = (const int*)rows, *op = (const int*)offsets;
  const float* al = (const float*)alpha;
  long long* cn = (long long*)counts;
  constexpr int gran = dec::kc_gran<xp::F>();
  const int whole = (K + gran - 1) / gran * gran, kc = whole < dec::MAX_KC ? whole : dec::MAX_KC;
  auto tiles = [&](auto* cp) {
    if (max_rows <= 4)
      return xp::launch_vec<4>(ap, a_m, a_k, asp, as_m, as_g, rp, op, E, bp, b_e, b_k, bsp, bs_e,
                               bs_g, al, alpha_val, cp, cn, N, K, kc, st);
    if (max_rows <= 8)
      return xp::launch_vec<8>(ap, a_m, a_k, asp, as_m, as_g, rp, op, E, bp, b_e, b_k, bsp, bs_e,
                               bs_g, al, alpha_val, cp, cn, N, K, kc, st);
    return xp::launch_vec<16>(ap, a_m, a_k, asp, as_m, as_g, rp, op, E, bp, b_e, b_k, bsp, bs_e,
                              bs_g, al, alpha_val, cp, cn, N, K, kc, st);
  };
  return out_f32 ? tiles((float*)c) : tiles((__nv_bfloat16*)c);
}
