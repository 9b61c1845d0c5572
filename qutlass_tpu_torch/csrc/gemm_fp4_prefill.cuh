// The tensor-core prefill kernel of the fp4 GEMMs, shared by K7
// (gemm_fp4_nv.cu, NVFP4: 16-groups, e4m3 scales) and K4 (gemm_fp4_mx.cu,
// MXFP4: 32-groups, e8m0 scales), templated on the format (dec::Nv,
// dec::Mx of gemm_fp4_decode.cuh: the group width G and a scale byte's
// value):
//   C[m, n] = out( float(sum_g p_g sa_g sb_g) * alpha ),
// p_g a group's exact sum of e2m1 products, sa_g and sb_g its two scales,
// the terms added into one fp64 sum an output in ascending k.  It takes
// every call that the decode kernel does not: the row-major (tn) layout at
// any M, the K-major one above 16 rows, and (K4) unpacked activation codes.
//
// Bound by the fp64 fold, two DFMA an output and group (33.5 TFLOP/s on
// the H100's CUDA cores: at (M, K, N) = (512, 4096, 12288) 0.19 ms for NV,
// 0.096 for MX), not by the int8 products (0.026 ms at the int8 peak).
//
// A block of 4 warps owns 64 x 64 outputs, a warp 32 x 32, a thread 32 in
// fp64 (at most 168 registers: three blocks an SM); where that grid would
// hold fewer than two blocks an SM (M = 64, or N = 1024 at M = 512) a block
// owns 64 x 32 and twice as many blocks run.  Each K step stages a slab of
// 64 k of both operands in shared memory as int8 m2 (the doubled e2m1
// values, integers in [-12, 12]), k contiguous along each row (the
// mma.sync fragment layout), in 32-byte rows whose 4-byte words are
// XOR-swizzled so that the transposing stores and the fragment loads are
// free of bank conflicts, beside the slab's 64 / G scale rows as fp64
// ({sa / 4, -MAGIC sa / 4} for a's rows, sb for b's, from tables of the
// 256 bytes: both exact for an e4m3 value and for every power of two
// 2^-127 .. 2^127).  The next slab's bytes are loaded into registers
// while the current one is multiplied, then turned into m2 and stored
// into the other of two buffers: one barrier a step.  A K-major operand
// arrives with rows contiguous, 4 rows x 2 packed k-rows a load pair, and
// is transposed in registers by byte permutes; any other layout is read
// byte by byte through its strides, and unpacked codes (one byte a k) are
// packed two to a byte as they arrive.
//
// Each group of a 16 x 8 output tile is one int8 mma.sync from a zero
// accumulator: m16n8k16 for a 16-group, m16n8k32 for a 32-group (one
// MMA's k is one group: never a k that mixes two groups' scales), whose
// int32 results are the group's s = 4p exactly (|s| <= 32 * 144).  Each
// output folds fma(fma(MAGIC + s, sa / 4, -MAGIC sa / 4), sb, acc), MAGIC
// + s built from bits: p sa exactly, then acc + p sa sb rounded once, the
// term exact for every scale byte but a NaN.  So the kernel is bitwise
// the fp4 tile's fold (gemm_fp4_tile.cuh, which K16 and K17 run) even
// where the fp64 sums round.  No split-K, no workspace, no counters:
// graph-safe by construction.  alpha is read from device memory, or taken
// by value where alpha_ptr is null.
#pragma once

#include "gemm_fp4_decode.cuh"

namespace {
namespace pre {

using dec::m2x4;

// 2 x 2 warps; a warp owns 32 rows x 8 NT columns, NT = 4 (64 x 64 block
// tile) or 2 (64 x 32, for grids under about two blocks an SM)
constexpr int WM = 2, WN = 2, THREADS = 32 * WM * WN;
constexpr int BM = 32 * WM;
constexpr int BK = 64;                     // a slab: 64 / G groups
constexpr int SUBS = BK / 32;
// resident blocks an SM (__launch_bounds__): 3 leaves 168 registers a
// thread, and no spills; 4 caps them at 128 and spills
constexpr int MIN_BLOCKS = 3;
// the 64 x 32 tile below SMALL_BELOW x SMs blocks of 64 x 64
constexpr int SMALL_BELOW = 2;
// how an operand is read: bytes through its strides, 4-byte words of 4
// contiguous rows, or unpacked codes (one byte a k) through its strides
constexpr int BYTES = 0, VEC = 1, CODES = 2;
__host__ __device__ constexpr int bn(int nt) { return 8 * nt * WN; }
template <typename F>
__host__ __device__ constexpr int groups() { return BK / F::G; }
template <typename F>
__host__ __device__ constexpr int lg_g() { return F::G == 16 ? 4 : 5; }
// a thread stages units(rows) units of 4 rows x 4 k of an operand's slab
// and scs<F>(rows) of its scale bytes (the last partly idle where the
// slab holds fewer scale bytes than threads)
__host__ __device__ constexpr int units(int rows) { return rows / 4 * (BK / 4) / THREADS; }
template <typename F>
__host__ __device__ constexpr int scs(int rows) { return (groups<F>() * rows + THREADS - 1) / THREADS; }
// log2 of an operand tile's rows: indices below are shifts and masks
__host__ __device__ constexpr int lg(int rows) { return rows == 64 ? 6 : 5; }
static_assert(units(32) * THREADS == 8 * (BK / 4), "the staging maps a slab's 4-row quads onto the threads");

// one buffer of the slab: m2 bytes, the 4-byte word of (row r, k quad c)
// at a[c / 8][r][(c % 8) ^ swz(r)]; a's scale pairs, b's scales
template <typename F, int BN>
struct Slab {
  uint32_t a[SUBS][BM][8];
  uint32_t b[SUBS][BN][8];
  double2 sa[groups<F>()][BM];  // {sa / 4, -MAGIC sa / 4}
  double sb[groups<F>()][BN];
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
// aligned words (the host checked the base, q_k and R); CODES: the code of
// k at q[r q_r + k q_k], a packed byte built as code[k] | code[k + 1] << 4
template <typename F, int ROWS, int LD>
__device__ __forceinline__ void fetch(uint32_t (&x)[units(ROWS)][2], uint32_t (&sc)[scs<F>(ROWS)],
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
      if constexpr (LD == VEC) {
        if (r < R) {
          x[u][0] = __ldg(reinterpret_cast<const unsigned int*>(q + (long long)kp * q_k + r));
          x[u][1] = __ldg(reinterpret_cast<const unsigned int*>(q + (long long)(kp + 1) * q_k + r));
        }
      } else if constexpr (LD == CODES) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (r + j < R) {
            const uint8_t* p = q + (long long)(r + j) * q_r + (long long)(2 * kp) * q_k;
            const uint32_t lo = (__ldg(p) & 0xF) | (__ldg(p + q_k) & 0xF) << 4;
            const uint32_t hi = (__ldg(p + 2 * q_k) & 0xF) | (__ldg(p + 3 * q_k) & 0xF) << 4;
            x[u][0] |= lo << (8 * j);
            x[u][1] |= hi << (8 * j);
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
  for (int u = 0; u < scs<F>(ROWS); ++u) {
    const int i = tid + u * THREADS, g = i >> lg(ROWS), r = r0 + (i & (ROWS - 1));
    const bool here = groups<F>() * ROWS % THREADS == 0 || i < groups<F>() * ROWS;
    sc[u] = (here && r < R && k0 + F::G * g < K)
                ? __ldg(s + (long long)r * s_r + (long long)((k0 >> lg_g<F>()) + g) * s_g)
                : 0;
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

// the scale bytes' table values into a slab's [group][row] array
template <typename F, int ROWS, typename T>
__device__ __forceinline__ void stage_scales(T (*t)[ROWS], const uint32_t (&sc)[scs<F>(ROWS)],
                                             const T* tab, int tid) {
#pragma unroll
  for (int u = 0; u < scs<F>(ROWS); ++u) {
    const int i = tid + u * THREADS;
    if (groups<F>() * ROWS % THREADS == 0 || i < groups<F>() * ROWS)
      t[i >> lg(ROWS)][i & (ROWS - 1)] = tab[sc[u]];
  }
}

// one group's int8 products of a 16 x 8 tile from a zero accumulator: d =
// {(g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)} for lane 4g + t.
// KW = G / 16 words of a row's k a lane: a = {row g, row g + 8} for each
// word (k 4t.., then 16 + 4t..), b = column g's words
template <int KW>
__device__ __forceinline__ void mma_group(int (&d)[4], const uint32_t (&a)[2 * KW],
                                          const uint32_t (&b)[KW]) {
  if constexpr (KW == 1) {
    asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
        "{%7, %7, %7, %7};\n"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(b[0]), "r"(0));
  } else {
    static_assert(KW == 2, "a 16- or 32-group");
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%10, %10, %10, %10};\n"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "r"(0));
  }
}

// acc + p sa sb, rounded once: s = 4 p, sa = {sa / 4, -MAGIC sa / 4};
// MAGIC + s is built from bits, and the inner fma is p sa, exact
__device__ __forceinline__ double fold(int s, double2 sa, double sb, double acc) {
  const double d = __hiloint2double(0x43380000, s ^ (int)0x80000000);  // MAGIC + s
  return fma(fma(d, sa.x, sa.y), sb, acc);
}

}  // namespace pre

template <typename F, int NT, int LA, int LB, typename Out>
__global__ void __launch_bounds__(pre::THREADS, pre::MIN_BLOCKS)
gemm_fp4_prefill(const uint8_t* __restrict__ a, long long a_m, long long a_k,
                 const uint8_t* __restrict__ as, long long as_m, long long as_g,
                 const uint8_t* __restrict__ b, long long b_n, long long b_k,
                 const uint8_t* __restrict__ bs, long long bs_n, long long bs_g,
                 const float* __restrict__ alpha_ptr, float alpha_val, Out* __restrict__ c, int M,
                 int N, int K) {
  using namespace pre;
  constexpr int BN = bn(NT), WC = 8 * NT;  // the block's and a warp's columns
  constexpr int GROUPS = groups<F>(), KW = F::G / 16, GW = F::G / 4;  // GW: a group's words
  __shared__ __align__(16) Slab<F, BN> slab[2];
  __shared__ double2 tab_a[256];  // each scale byte's {v / 4, -MAGIC v / 4} (both exact)
  __shared__ double tab_b[256];   // and its value v
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  for (int i = tid; i < 256; i += THREADS) {
    const double v = F::scale(i);
    tab_a[i] = make_double2(0.25 * v, -dec::MAGIC * (0.25 * v));
    tab_b[i] = v;
  }

  uint32_t xa[units(BM)][2], xb[units(BN)][2], sca[scs<F>(BM)], scb[scs<F>(BN)];
  auto fetch_slab = [&](int k0) {
    fetch<F, BM, LA>(xa, sca, a, a_m, a_k, as, as_m, as_g, m0, M, k0, K, tid);
    fetch<F, BN, LB>(xb, scb, b, b_n, b_k, bs, bs_n, bs_g, n0, N, k0, K, tid);
  };
  auto stage = [&](Slab<F, BN>& sl) {
    stage_codes<BM>(sl.a, xa, tid);
    stage_codes<BN>(sl.b, xb, tid);
    stage_scales<F, BM>(sl.sa, sca, tab_a, tid);
    stage_scales<F, BN>(sl.sb, scb, tab_b, tid);
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
    const Slab<F, BN>& sl = slab[step & 1];
#pragma unroll
    for (int grp = 0; grp < GROUPS; ++grp) {
      if (k0 + F::G * grp >= K) break;
      // the group's j-th word of a lane: k quad GW grp + t + 4 j of the slab
      uint32_t af[2][2 * KW];
      double2 sa[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 32 * wm + 16 * mt + 8 * h + g;
#pragma unroll
          for (int j = 0; j < KW; ++j) {
            const int w = GW * grp + t + 4 * j;
            af[mt][h + 2 * j] = sl.a[w >> 3][r][(w & 7) ^ swz(r)];
          }
          sa[mt][h] = sl.sa[grp][r];
        }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int r = WC * wn + 8 * nt + g;
        uint32_t bf[KW];
#pragma unroll
        for (int j = 0; j < KW; ++j) {
          const int w = GW * grp + t + 4 * j;
          bf[j] = sl.b[w >> 3][r][(w & 7) ^ swz(r)];
        }
        const double2 sb = *reinterpret_cast<const double2*>(&sl.sb[grp][WC * wn + 8 * nt + 2 * t]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          int d[4];
          mma_group<KW>(d, af[mt], bf);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[mt][nt][e] = fold(d[e], sa[mt][e >> 1], e & 1 ? sb.y : sb.x, acc[mt][nt][e]);
        }
      }
    }
    if (step + 1 < steps) stage(slab[(step + 1) & 1]);
    __syncthreads();
  }

  const float alpha = alpha_ptr != nullptr ? *alpha_ptr : alpha_val;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + 32 * wm + 16 * mt + g + 8 * (e >> 1);
        const int n = n0 + WC * wn + 8 * nt + 2 * t + (e & 1);
        if (m < M && n < N)
          qt::tile::out(c, (long long)m * N + n, __fmul_rn(__double2float_rn(acc[mt][nt][e]), alpha));
      }
}

namespace pre {

constexpr int kMaxDev = 64;

template <typename F, int LA, int LB, typename Out>
int launch(const uint8_t* a, long long a_m, long long a_k, const uint8_t* as, long long as_m,
           long long as_g, const uint8_t* b, long long b_n, long long b_k, const uint8_t* bs,
           long long bs_n, long long bs_g, const float* alpha, float alpha_val, Out* c, int M,
           int N, int K, cudaStream_t st) {
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
  const int rows = (M + BM - 1) / BM;
  if ((long long)rows * ((N + bn(4) - 1) / bn(4)) < (long long)SMALL_BELOW * n_sm) {
    const dim3 grid((N + bn(2) - 1) / bn(2), rows);
    gemm_fp4_prefill<F, 2, LA, LB, Out><<<grid, THREADS, 0, st>>>(
        a, a_m, a_k, as, as_m, as_g, b, b_n, b_k, bs, bs_n, bs_g, alpha, alpha_val, c, M, N, K);
  } else {
    const dim3 grid((N + bn(4) - 1) / bn(4), rows);
    gemm_fp4_prefill<F, 4, LA, LB, Out><<<grid, THREADS, 0, st>>>(
        a, a_m, a_k, as, as_m, as_g, b, b_n, b_k, bs, bs_n, bs_g, alpha, alpha_val, c, M, N, K);
  }
  return (int)cudaGetLastError();
}

// rows contiguous in 4-byte aligned words: the kernel's vector loads
inline bool vec_rows(const void* q, long long q_r, long long q_k, int rows) {
  return q_r == 1 && dec::aligned(q, 4) && q_k % 4 == 0 && rows % 4 == 0;
}

// the prefill kernel on packed operands (a as unpacked codes where
// A_CODES) of any strides, each vector-loaded where its layout allows;
// K % G == 0, and M within the grid's 65535 row tiles
template <typename F, bool A_CODES, typename Out>
int run(const uint8_t* a, long long a_m, long long a_k, const uint8_t* as, long long as_m,
        long long as_g, const uint8_t* b, long long b_n, long long b_k, const uint8_t* bs,
        long long bs_n, long long bs_g, const float* alpha, float alpha_val, Out* c, int M, int N,
        int K, cudaStream_t st) {
  if ((M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  const bool vb = vec_rows(b, b_n, b_k, N);
  if constexpr (A_CODES) {
    if (vb)
      return launch<F, CODES, VEC>(a, a_m, a_k, as, as_m, as_g, b, b_n, b_k, bs, bs_n, bs_g, alpha,
                                   alpha_val, c, M, N, K, st);
    return launch<F, CODES, BYTES>(a, a_m, a_k, as, as_m, as_g, b, b_n, b_k, bs, bs_n, bs_g, alpha,
                                   alpha_val, c, M, N, K, st);
  } else {
    const bool va = vec_rows(a, a_m, a_k, M);
    if (va && vb)
      return launch<F, VEC, VEC>(a, a_m, a_k, as, as_m, as_g, b, b_n, b_k, bs, bs_n, bs_g, alpha,
                                 alpha_val, c, M, N, K, st);
    if (va)
      return launch<F, VEC, BYTES>(a, a_m, a_k, as, as_m, as_g, b, b_n, b_k, bs, bs_n, bs_g, alpha,
                                   alpha_val, c, M, N, K, st);
    if (vb)
      return launch<F, BYTES, VEC>(a, a_m, a_k, as, as_m, as_g, b, b_n, b_k, bs, bs_n, bs_g, alpha,
                                   alpha_val, c, M, N, K, st);
    return launch<F, BYTES, BYTES>(a, a_m, a_k, as, as_m, as_g, b, b_n, b_k, bs, bs_n, bs_g, alpha,
                                   alpha_val, c, M, N, K, st);
  }
}

}  // namespace pre
}  // namespace
