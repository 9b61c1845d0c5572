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
// e2m1 products as an integer: the doubled values m2 = 2v are integers
// in [-12, 12], their 16 products sum to s = 4p exactly (p the group's
// sum, a multiple of 1/4 up to 36).  The term p sa sb (12 + 4 + 4
// significant bits: exact) is added into an fp64 accumulator with one
// rounding, as fma(fma(MAGIC + s, sa / 4, -MAGIC sa / 4), sb, acc), the
// double MAGIC + s built from bits (no int -> fp conversion).  Every group
// term is a multiple of 2^-20 and the fp64 sums stay exact while a row
// pair's group terms span fewer than ~40 binades; there the result,
// rounded once to fp32 and scaled by alpha, is bitwise the plain
// version's (fp64 sum of exact products, rounded once), and the order in
// which the terms are added does not change a bit.  Outside that regime
// no order is bitwise against the plain version; the prefill kernel adds
// each output's terms in ascending k, as the fp4 tile of
// gemm_fp4_tile.cuh does for K17, so K17 equals K5 + K7 there too.
//
// The launcher picks one of two kernels:
//
// Decode (dec::gemm_fp4_decode<dec::Nv>, gemm_fp4_decode.cuh, shared with
// K4): the K-major layout at M <= 16, the serving path's call (weight
// packed [K/2, N], scales [K/16, N]; activation [K/2, M] and [K/16, M]).
// Bound by the weight bytes, 0.5625 byte an element (3.35 TB/s: 8.5 us at
// K x N = 4096 x 12288).  Split-K over blocks that stream the weight from
// device memory into registers; the last block of a column tile adds the
// fp64 partials in split order, in one launch and with no host sync.
//
// Prefill (gemm_fp4_nv_prefill): every other call, the row-major (tn)
// layout at any M and the K-major one at M > 16.  Bound by the fp64 fold,
// two DFMA an output and group (33.5 TFLOP/s on the H100's CUDA cores:
// 0.19 ms at (M, K, N) = (512, 4096, 12288)), not by the int8 products.
// A block of 4 warps owns 64 x 64 outputs, a warp 32 x 32, a thread 32 in
// fp64 (at most 168 registers: three blocks an SM); where that grid would
// hold fewer than two blocks an SM (M = 64, or N = 1024 at M = 512) a
// block owns 64 x 32 and twice as many blocks run.  Each K step stages a slab
// of 64 k of both operands in shared memory as int8 m2, k contiguous along
// each row (the mma.sync fragment layout), in 32-byte rows whose 4-byte
// words are XOR-swizzled so that the transposing stores and the fragment
// loads are free of bank conflicts, beside the slab's scales as fp64
// ({sa / 4, -MAGIC sa / 4} for a's rows, sb for b's, from tables of the
// 256 bytes).  The next slab's bytes are loaded into registers while the
// current one is multiplied, then turned into m2 and stored into the
// other of two buffers: one barrier a step.  A K-major operand arrives
// with rows contiguous, 4 rows x 2 packed k-rows a load pair, and is
// transposed in registers by byte permutes; any other layout is read byte
// by byte through its strides.  Each 16-group of a 16 x 8 output tile is
// one mma.sync.m16n8k16 s8 x s8 -> s32 from a zero accumulator (k16 is one
// group: the k32 shape and wgmma would mix two groups with different
// scales), whose int32 results are the group's s; every output folds its
// terms in ascending k into one fp64 chain.  No split-K, no workspace, no
// counters: graph-safe by construction.
//
// alpha is read from device memory by both kernels.
#include "gemm_fp4_decode.cuh"
#include "gemm_fp4_tile.cuh"

namespace {

using namespace qt::tile;
using dec::m2x4;

// ---------------------------------------------------------------------------
// prefill: every other call; int8 mma.sync group sums, one fp64 chain an output
// ---------------------------------------------------------------------------

namespace pre {
// 2 x 2 warps; a warp owns 32 rows x 8 NT columns, NT = 4 (64 x 64 block
// tile) or 2 (64 x 32, for grids under about two blocks an SM)
constexpr int WM = 2, WN = 2, THREADS = 32 * WM * WN;
constexpr int BM = 32 * WM;
constexpr int BK = 64;                     // a slab: four 16-groups
constexpr int GROUPS = BK / 16, SUBS = BK / 32;
// resident blocks an SM (__launch_bounds__): 3 leaves 168 registers a
// thread, and no spills; 4 caps them at 128 and spills
constexpr int MIN_BLOCKS = 3;
// the 64 x 32 tile below SMALL_BELOW x SMs blocks of 64 x 64
constexpr int SMALL_BELOW = 2;
__host__ __device__ constexpr int bn(int nt) { return 8 * nt * WN; }
// a thread stages units(rows) units of 4 rows x 4 k of an operand's slab
// and scs(rows) of its scale bytes
__host__ __device__ constexpr int units(int rows) { return rows / 4 * (BK / 4) / THREADS; }
__host__ __device__ constexpr int scs(int rows) { return GROUPS * rows / THREADS; }
// log2 of an operand tile's rows: indices below are shifts and masks
__host__ __device__ constexpr int lg(int rows) { return rows == 64 ? 6 : 5; }
static_assert(units(32) * THREADS == 8 * (BK / 4) && scs(32) * THREADS == GROUPS * 32,
              "the staging maps a slab's 4-row quads onto the threads");

// one buffer of the slab: m2 bytes, the 4-byte word of (row r, k quad c)
// at a[c / 8][r][(c % 8) ^ swz(r)]; a's scale pairs, b's scales
template <int BN>
struct Slab {
  uint32_t a[SUBS][BM][8];
  uint32_t b[SUBS][BN][8];
  double2 sa[GROUPS][BM];  // {sa / 4, -MAGIC sa / 4}
  double sb[GROUPS][BN];
};

// the word swizzle of row r: a warp's fragment loads (rows r0..r0+7, quads
// t or 4 + t) hit 32 distinct banks, and so do its staging stores of a
// 64-row operand (16 row quads x 2 k quads, each lane writing its 4 rows
// in a rotated order; a 32-row operand's 8 x 4 conflict two-way)
__device__ __forceinline__ int swz(int r) { return (4 * ((r >> 2) & 1)) ^ (2 * ((r >> 4) & 3)); }

// the raw bytes of a ROWS-row operand's slab: for unit u, packed k-rows kp
// and kp + 1 (k = k0 + 4c .. + 3) of rows r0 + 4qd .. + 3, row j in byte j;
// the scale bytes of (group, row) i = tid + u THREADS at (i / ROWS, i %
// ROWS).  Zero beyond R and K.  VEC: rows contiguous (q_r == 1), 4-byte
// aligned words (the host checked the base, q_k and R)
template <int ROWS, bool VEC>
__device__ __forceinline__ void fetch(uint32_t (&x)[units(ROWS)][2], uint32_t (&sc)[scs(ROWS)],
                                      const uint8_t* __restrict__ q, long long q_r, long long q_k,
                                      const uint8_t* __restrict__ s, long long s_r, long long s_g,
                                      int r0, int R, int k0, int K, int tid) {
  static_assert(ROWS == 64 || ROWS == 32, "a 32- or 64-row operand tile");
#pragma unroll
  for (int u = 0; u < units(ROWS); ++u) {
    const int i = tid + u * THREADS, qd = i & (ROWS / 4 - 1), c = i >> (lg(ROWS) - 2);
    const int r = r0 + 4 * qd, kp = (k0 >> 1) + 2 * c;
    x[u][0] = x[u][1] = 0;
    if (k0 + 4 * c < K) {  // K % 16 == 0: a quad is all in or all out
      if constexpr (VEC) {
        if (r < R) {
          x[u][0] = __ldg(reinterpret_cast<const unsigned int*>(q + (long long)kp * q_k + r));
          x[u][1] = __ldg(reinterpret_cast<const unsigned int*>(q + (long long)(kp + 1) * q_k + r));
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (r + j < R) {
            const uint8_t* p = q + (long long)(r + j) * q_r + (long long)kp * q_k;
            x[u][0] |= (uint32_t)__ldg(p) << (8 * j);
            x[u][1] |= (uint32_t)__ldg(p + q_k) << (8 * j);
          }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < scs(ROWS); ++u) {
    const int i = tid + u * THREADS, g = i >> lg(ROWS), r = r0 + (i & (ROWS - 1));
    sc[u] = (r < R && k0 + 16 * g < K) ? __ldg(s + (long long)r * s_r + (long long)((k0 >> 4) + g) * s_g) : 0;
  }
}

// the fetched bytes as m2 into t (a unit's 4 rows: row 4qd + j gets codes
// k..k+3 from byte j of both k-rows), each lane starting at row j = qd % 4
template <int ROWS>
__device__ __forceinline__ void stage_codes(uint32_t (*t)[ROWS][8],
                                            const uint32_t (&x)[units(ROWS)][2], int tid) {
#pragma unroll
  for (int u = 0; u < units(ROWS); ++u) {
    const int i = tid + u * THREADS, qd = i & (ROWS / 4 - 1), c = i >> (lg(ROWS) - 2);
    const int col = (c & 7) ^ swz(4 * qd);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int j = (v + qd) & 3;
      t[c >> 3][4 * qd + j][col] = m2x4(__byte_perm(x[u][0], x[u][1], j | ((j + 4) << 4)));
    }
  }
}

// one 16-group's int8 products of a 16 x 8 tile from a zero accumulator:
// d = {(g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)} for lane 4g + t
__device__ __forceinline__ void mma_group(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%7, %7, %7, %7};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(b), "r"(0));
}

// acc + p sa sb, rounded once: s = 4 p, sa = {sa / 4, -MAGIC sa / 4};
// MAGIC + s is built from bits, and the inner fma is p sa, exact
__device__ __forceinline__ double fold(int s, double2 sa, double sb, double acc) {
  const double d = __hiloint2double(0x43380000, s ^ (int)0x80000000);  // MAGIC + s
  return fma(fma(d, sa.x, sa.y), sb, acc);
}

}  // namespace pre

template <int NT, bool VA, bool VB, typename Out>
__global__ void __launch_bounds__(pre::THREADS, pre::MIN_BLOCKS)
gemm_fp4_nv_prefill(const uint8_t* __restrict__ a, long long a_m, long long a_k,
                    const uint8_t* __restrict__ as, long long as_m, long long as_g,
                    const uint8_t* __restrict__ b, long long b_n, long long b_k,
                    const uint8_t* __restrict__ bs, long long bs_n, long long bs_g,
                    const float* __restrict__ alpha_ptr, Out* __restrict__ c, int M, int N, int K) {
  using namespace pre;
  constexpr int BN = bn(NT), WC = 8 * NT;  // the block's and a warp's columns
  __shared__ __align__(16) Slab<BN> slab[2];
  __shared__ double2 tab_a[256];  // each e4m3 byte's {v / 4, -MAGIC v / 4} (both exact)
  __shared__ double tab_b[256];   // and its value v
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  for (int i = tid; i < 256; i += THREADS) {
    const double v = (double)qt::e4m3_decode(i);
    tab_a[i] = make_double2(0.25 * v, -dec::MAGIC * (0.25 * v));
    tab_b[i] = v;
  }

  uint32_t xa[units(BM)][2], xb[units(BN)][2], sca[scs(BM)], scb[scs(BN)];
  auto fetch_slab = [&](int k0) {
    fetch<BM, VA>(xa, sca, a, a_m, a_k, as, as_m, as_g, m0, M, k0, K, tid);
    fetch<BN, VB>(xb, scb, b, b_n, b_k, bs, bs_n, bs_g, n0, N, k0, K, tid);
  };
  auto stage = [&](Slab<BN>& sl) {
    stage_codes<BM>(sl.a, xa, tid);
    stage_codes<BN>(sl.b, xb, tid);
#pragma unroll
    for (int u = 0; u < scs(BM); ++u) {
      const int i = tid + u * THREADS;
      sl.sa[i >> lg(BM)][i & (BM - 1)] = tab_a[sca[u]];
    }
#pragma unroll
    for (int u = 0; u < scs(BN); ++u) {
      const int i = tid + u * THREADS;
      sl.sb[i >> lg(BN)][i & (BN - 1)] = tab_b[scb[u]];
    }
  };

  // the thread's outputs [mt][nt][e]: row 32 wm + 16 mt + g + 8 (e / 2),
  // column WC wn + 8 nt + 2 t + e % 2
  double acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;

  fetch_slab(0);
  __syncthreads();  // the tables
  stage(slab[0]);
  __syncthreads();
  const int steps = (K + BK - 1) / BK;
  for (int step = 0; step < steps; ++step) {
    const int k0 = step * BK;
    if (step + 1 < steps) fetch_slab(k0 + BK);  // in flight while this slab is multiplied
    const Slab<BN>& sl = slab[step & 1];
#pragma unroll
    for (int grp = 0; grp < GROUPS; ++grp) {
      if (k0 + 16 * grp >= K) break;
      const int sub = grp >> 1, cq = 4 * (grp & 1) + t;
      uint32_t af[2][2];
      double2 sa[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 32 * wm + 16 * mt + 8 * h + g;
          af[mt][h] = sl.a[sub][r][cq ^ swz(r)];
          sa[mt][h] = sl.sa[grp][r];
        }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int r = WC * wn + 8 * nt + g;
        const uint32_t bf = sl.b[sub][r][cq ^ swz(r)];
        const double2 sb = *reinterpret_cast<const double2*>(&sl.sb[grp][WC * wn + 8 * nt + 2 * t]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          int d[4];
          mma_group(d, af[mt][0], af[mt][1], bf);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[mt][nt][e] = fold(d[e], sa[mt][e >> 1], e & 1 ? sb.y : sb.x, acc[mt][nt][e]);
        }
      }
    }
    if (step + 1 < steps) stage(slab[(step + 1) & 1]);
    __syncthreads();
  }

  const float alpha = *alpha_ptr;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + 32 * wm + 16 * mt + g + 8 * (e >> 1);
        const int n = n0 + WC * wn + 8 * nt + 2 * t + (e & 1);
        if (m < M && n < N)
          out(c, (long long)m * N + n, __fmul_rn(__double2float_rn(acc[mt][nt][e]), alpha));
      }
}

constexpr int kMaxDev = 64;

template <bool VA, bool VB, typename Out>
int launch_prefill(const uint8_t* a, long long a_m, long long a_k, const uint8_t* as,
                   long long as_m, long long as_g, const uint8_t* b, long long b_n, long long b_k,
                   const uint8_t* bs, long long bs_n, long long bs_g, const float* alpha, Out* c,
                   int M, int N, int K, cudaStream_t st) {
  static int sms[kMaxDev] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int n_sm = dev < kMaxDev ? sms[dev] : 0;
  if (n_sm == 0) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDev) sms[dev] = n_sm;
  }
  const int rows = (M + pre::BM - 1) / pre::BM;
  if ((long long)rows * ((N + pre::bn(4) - 1) / pre::bn(4)) < (long long)pre::SMALL_BELOW * n_sm) {
    const dim3 grid((N + pre::bn(2) - 1) / pre::bn(2), rows);
    gemm_fp4_nv_prefill<2, VA, VB, Out><<<grid, pre::THREADS, 0, st>>>(
        a, a_m, a_k, as, as_m, as_g, b, b_n, b_k, bs, bs_n, bs_g, alpha, c, M, N, K);
  } else {
    const dim3 grid((N + pre::bn(4) - 1) / pre::bn(4), rows);
    gemm_fp4_nv_prefill<4, VA, VB, Out><<<grid, pre::THREADS, 0, st>>>(
        a, a_m, a_k, as, as_m, as_g, b, b_n, b_k, bs, bs_n, bs_g, alpha, c, M, N, K);
  }
  return (int)cudaGetLastError();
}

// rows contiguous in 4-byte aligned words: the prefill kernel's vector loads
bool vec_rows(const void* q, long long q_r, long long q_k, int rows) {
  return q_r == 1 && dec::aligned(q, 4) && q_k % 4 == 0 && rows % 4 == 0;
}

template <typename Out>
int launch_prefill_vec(const uint8_t* a, long long a_m, long long a_k, const uint8_t* as,
                       long long as_m, long long as_g, const uint8_t* b, long long b_n,
                       long long b_k, const uint8_t* bs, long long bs_n, long long bs_g,
                       const float* alpha, Out* c, int M, int N, int K, cudaStream_t st) {
  const bool va = vec_rows(a, a_m, a_k, M), vb = vec_rows(b, b_n, b_k, N);
  if (va && vb)
    return launch_prefill<true, true>(a, a_m, a_k, as, as_m, as_g, b, b_n, b_k, bs, bs_n, bs_g,
                                      alpha, c, M, N, K, st);
  if (va)
    return launch_prefill<true, false>(a, a_m, a_k, as, as_m, as_g, b, b_n, b_k, bs, bs_n, bs_g,
                                       alpha, c, M, N, K, st);
  if (vb)
    return launch_prefill<false, true>(a, a_m, a_k, as, as_m, as_g, b, b_n, b_k, bs, bs_n, bs_g,
                                       alpha, c, M, N, K, st);
  return launch_prefill<false, false>(a, a_m, a_k, as, as_m, as_g, b, b_n, b_k, bs, bs_n, bs_g,
                                      alpha, c, M, N, K, st);
}

}  // namespace

// a'[m, kp] = a[m * a_m + kp * a_k] (packed, kp = k / 2), a's scales
// as[m * as_m + g * as_g]; likewise b' [N, K/2] and bs; alpha fp32 on the
// device; c [M, N] bf16 or (out_f32) fp32; K % 16 == 0.  With part ==
// nullptr the prefill kernel runs, on any strides.  With part, the decode
// kernel (gemm_fp4_decode.cuh's dec::run): M <= 16, b and bs K-major (b_n
// == bs_n == 1), kc a multiple of 128 and at most 2048, part and counters
// as dec::run states.  What a kernel does not take returns
// cudaErrorInvalidValue.
extern "C" int qt_gemm_fp4_nv(const void* a, long long a_m, long long a_k, const void* as,
                              long long as_m, long long as_g, const void* b, long long b_n,
                              long long b_k, const void* bs, long long bs_n, long long bs_g,
                              const void* alpha, void* c, int out_f32, int M, int N, int K,
                              void* part, void* counters, int kc, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const uint8_t *ap = (const uint8_t*)a, *asp = (const uint8_t*)as;
  const uint8_t *bp = (const uint8_t*)b, *bsp = (const uint8_t*)bs;
  const float* al = (const float*)alpha;
  if (M <= 0 || N <= 0 || K <= 0 || K % 16) return (int)cudaErrorInvalidValue;
  if (part != nullptr) {
    if (b_n != 1 || bs_n != 1) return (int)cudaErrorInvalidValue;
    return dec::run<dec::Nv>(ap, a_m, a_k, asp, as_m, as_g, bp, b_k, bsp, bs_g, al, 0.f, c, out_f32,
                             M, N, K, kc, (double*)part, (int*)counters, st);
  }
  if ((M + pre::BM - 1) / pre::BM > 65535) return (int)cudaErrorInvalidValue;
  if (out_f32)
    return launch_prefill_vec<float>(ap, a_m, a_k, asp, as_m, as_g, bp, b_n, b_k, bsp, bs_n, bs_g,
                                     al, (float*)c, M, N, K, st);
  return launch_prefill_vec<__nv_bfloat16>(ap, a_m, a_k, asp, as_m, as_g, bp, b_n, b_k, bsp, bs_n,
                                           bs_g, al, (__nv_bfloat16*)c, M, N, K, st);
}
