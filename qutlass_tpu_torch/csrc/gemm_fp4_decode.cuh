// The split-K decode kernel of the fp4 GEMMs at M <= 16, K-major, shared
// by K7 (gemm_fp4_nv.cu, NVFP4: 16-groups, e4m3 scales) and K4
// (gemm_fp4_mx.cu, MXFP4: 32-groups, e8m0 scales), templated on the
// format:
//   C[m, n] = out( float(sum_g s p_g sa_g sb_g) * alpha ),
// p_g a group's exact sum of e2m1 products, sa_g and sb_g its two scales.
//
// Layout: the weight packed [K/2, N] and its scales [K/G, N], unit stride
// along N; the activation [K/2, M] and [K/G, M], any strides.  Bound by
// the weight bytes (1/2 + 1/G byte an element at 3.35 TB/s: 8.5 us at K x
// N = 4096 x 12288 for NV, 8.0 for MX).
//
// A block of 8 warps owns 32 C adjacent columns (C = 4, 2, 1 for M <= 4,
// 8, 16: the fp64 accumulators, M C a thread, bound the columns) and one
// slice of K (split-K, so that even N = 1024 fills the SMs); its warps
// take the slice's groups in turn.  A thread reads its C columns of each
// of a group's G/2 byte rows and of its scale row with one load each,
// straight from device memory into registers, the next groups' loads in
// flight while it multiplies, with no shared-memory slab and no barrier in
// the K loop.  The block's slice of the activation is staged once in
// shared memory as int8 m2 (the doubled e2m1 values, integers in [-12,
// 12]) and scale pairs {sa / 4, -MAGIC sa / 4}, both exact for an e4m3
// value and for a power of two.  The weight's codes become m2 bytes by
// three byte permutes against tables and __dp4a multiplies four k at a
// time: a group's s = 4 p is an exact int (|s| <= 32 * 144).  The term is
// fma(fma(MAGIC + s, sa / 4, -MAGIC sa / 4), sb, acc), MAGIC + s built
// from bits (no int -> fp conversion): p sa exactly, then acc + p sa sb
// rounded once, with the scales' fp64 values from a table of the 256
// bytes (NV: e4m3; MX: 2^(byte - 127), NaN at 255).  Every term is exact
// in fp64, so the fp64 sums stay exact while a row pair's group terms
// span fewer than ~40 binades; there any order of the additions gives
// the same bits.  Each block adds its warps' fp64 sums in warp order and
// writes them to a workspace the wrapper allocates; the last block of a
// column tile to arrive (a per-tile counter, which it resets) adds the
// splits in order, rounds once to fp32 and multiplies by alpha (read from
// device memory, or a number passed by value where alpha_ptr is null), in
// one launch and with no host sync.
#pragma once

#include "gemm_fp4_tile.cuh"

namespace {
namespace dec {

constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int MAX_KC = 2048;
constexpr int DEPTH = 2;     // NV: groups whose loads are in flight while one is multiplied
constexpr int MX_DEPTH = 1;  // MX: the same for 32-groups (17 words a group; 2 spills)
constexpr int COLS4 = 4;     // columns a thread owns at M <= 4
// columns a thread owns at row bucket mb (mb x cols fp64 accumulators)
__host__ __device__ constexpr int cols(int mb) { return mb == 4 ? COLS4 : 16 / mb; }
__host__ __device__ constexpr int tile(int mb) { return 32 * cols(mb); }
// 2^52 + 2^51 + 2^31: the double whose low word is s + 2^31 is MAGIC + s
constexpr double MAGIC = 6755401588539392.0;

// the formats: group width G, ring depth, and a scale byte's fp64 value
struct Nv {
  static constexpr int G = 16, depth = DEPTH;
  __device__ static double scale(int byte) { return (double)qt::e4m3_decode(byte); }
};
struct Mx {
  static constexpr int G = 32, depth = MX_DEPTH;
  __device__ static double scale(int byte) { return (double)qt::e8m0_decode(byte); }
};
// a slice is a whole number of groups per warp
template <typename F>
__host__ __device__ constexpr int kc_gran() { return F::G * WARPS; }

// the staged slice: int8 m2 [mb][kc], the scale pairs {sa / 4, -MAGIC sa /
// 4} as double2 [mb][kc / G], the scale table double [256]; after the K
// loop the first 32 KB hold the warps' fp64 sums [WARPS][16][32]
__host__ __device__ constexpr size_t act_bytes(int mb, int kc) { return (size_t)mb * kc; }
__host__ __device__ constexpr size_t sc_bytes(int mb, int kc, int g) {
  return (size_t)mb * (kc / g) * 16;
}
__host__ __device__ constexpr size_t smem(int mb, int kc, int g) {
  return act_bytes(mb, kc) + sc_bytes(mb, kc, g) + 256 * 8 > (size_t)WARPS * 16 * 32 * 8
             ? act_bytes(mb, kc) + sc_bytes(mb, kc, g) + 256 * 8
             : (size_t)WARPS * 16 * 32 * 8;
}

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

// one group: w[r] holds byte row (G/2) g + r (k = G g + 2r low nibble, + 1
// high) of the thread's C columns, w[G/2] their scale bytes; act_g the
// group's m2 of row m at act_g + m * kc (G bytes, k ascending), sc_g its
// scale pair at sc_g[m * gpr], tab the scale bytes' values.  s, the int
// sum of G m2 products, is 4 p with p the fp4 tile's exact group sum;
// MAGIC + s is formed from bits, and fma(MAGIC + s, sa / 4, -MAGIC sa / 4)
// = p sa exactly (one rounding of an exact value), so the term added,
// fma(p sa, sb, acc), is acc + the exact term p sa sb, rounded once
template <typename F, int MB, int C>
__device__ __forceinline__ void group(double (&acc)[MB][C], const uint32_t (&w)[F::G / 2 + 1],
                                      const int8_t* act_g, int kc, const double2* sc_g, int gpr,
                                      const double* tab) {
  constexpr int Q = F::G / 4;  // words of 4 k
  uint32_t wv[C][Q];           // column j's m2 of k = 4rp..4rp+3, from byte rows 2rp and 2rp + 1
  double sb[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
#pragma unroll
    for (int rp = 0; rp < Q; ++rp)
      wv[j][rp] = m2x4(__byte_perm(w[2 * rp], w[2 * rp + 1], j | ((4 + j) << 4)));
    sb[j] = tab[(w[F::G / 2] >> (8 * j)) & 0xFF];
  }
#pragma unroll
  for (int m = 0; m < MB; ++m) {
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

template <typename F, int MB, bool VEC, typename Out>
__global__ void __launch_bounds__(THREADS, 2)
gemm_fp4_decode(const uint8_t* __restrict__ a, long long a_m, long long a_k,
                const uint8_t* __restrict__ as, long long as_m, long long as_g,
                const uint8_t* __restrict__ b, long long b_k, const uint8_t* __restrict__ bs,
                long long bs_g, const float* __restrict__ alpha_ptr, float alpha_val,
                Out* __restrict__ c, int M, int N, int K, int kc, double* __restrict__ part,
                int* __restrict__ counters) {
  constexpr int G = F::G, R = G / 2, C = cols(MB), W = tile(MB);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* act = reinterpret_cast<int8_t*>(smem_raw);                               // [MB][kc]
  double2* sc_s = reinterpret_cast<double2*>(smem_raw + act_bytes(MB, kc));       // [MB][kc/G]
  double* tab = reinterpret_cast<double*>(smem_raw + act_bytes(MB, kc) + sc_bytes(MB, kc, G));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * W, split = blockIdx.y, splits = gridDim.y;
  const int kbeg = split * kc, kend = min(K, kbeg + kc);
  const int gbeg = kbeg / G, gend = kend / G, gpr = kc / G;
  const int valid = N - (n0 + lane * C);
  const uint8_t* bp = b + n0 + lane * C;
  const uint8_t* sp = bs + n0 + lane * C;

  constexpr int D = F::depth, WS = WARPS;
  uint32_t buf[D + 1][R + 1];  // a ring of groups' weight bytes
  auto fetch = [&](uint32_t (&f)[R + 1], int g) {
    const uint8_t* row = bp + (long long)(R * g) * b_k;
#pragma unroll
    for (int r = 0; r < R; ++r, row += b_k) f[r] = load_cols<C, VEC>(row, valid);
    f[R] = load_cols<C, VEC>(sp + (long long)g * bs_g, valid);
  };
  int g = gbeg + warp;
#pragma unroll
  for (int u = 0; u < D; ++u)  // in flight while the activation is staged
    if (g + u * WS < gend) fetch(buf[u], g + u * WS);

  // the slice's activation: m2 bytes of k = 2kp, 2kp + 1 per packed byte,
  // the scale pairs and the scale table; rows M..MB-1 and k beyond the
  // slice are zero
  const int nkp = (kend - kbeg) >> 1;
  for (int i0 = tid; i0 < MB * (kc >> 1); i0 += 4 * THREADS) {
    int byte[4];  // four loads in flight, then their stores
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * THREADS, m = i % MB, kp = i / MB;
      byte[u] = (m < M && kp < nkp) ? a[(long long)m * a_m + (long long)((kbeg >> 1) + kp) * a_k] : 0;
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
    const double sa =
        (m < M && gg < gend - gbeg)
            ? 0.25 * F::scale(as[(long long)m * as_m + (long long)(gbeg + gg) * as_g])
            : 0.0;
    sc_s[m * gpr + gg] = make_double2(sa, -MAGIC * sa);  // both exact
  }
  tab[tid] = F::scale(tid);  // THREADS == 256
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
      group<F, MB, C>(acc, buf[u], act + (gu - gbeg) * G, kc, sc_s + (gu - gbeg), gpr, tab);
    }
  }

  // the warps' sums, added in warp order: the block's fp64 partial of
  // (split, m, n), written to part[split][m][n]
  __syncthreads();  // every warp is done with the staged slice
  double* red = reinterpret_cast<double*>(smem_raw);  // [WARPS][MB * C][32]
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int j = 0; j < C; ++j) red[(warp * MB * C + m * C + j) * 32 + lane] = acc[m][j];
  __syncthreads();
  for (int o = tid; o < MB * W; o += THREADS) {
    const int m = o / W, col = o % W, n = n0 + col;
    if (m < M && n < N) {
      double s = 0.0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[(w * MB * C + m * C + col % C) * 32 + col / C];
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
  const float alpha = alpha_ptr != nullptr ? *alpha_ptr : alpha_val;
  for (int o = tid; o < MB * W; o += THREADS) {
    const int m = o / W, n = n0 + o % W;
    if (m < M && n < N) {
      double s = 0.0;
      for (int sp = 0; sp < splits; ++sp) s += __ldcg(part + ((long long)sp * M + m) * N + n);
      qt::tile::out(c, (long long)m * N + n, __fmul_rn(__double2float_rn(s), alpha));
    }
  }
  if (tid == 0) counters[blockIdx.x] = 0;  // ready for the next launch (and graph replay)
}

constexpr int kMaxDev = 64;

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename F, int MB, bool VEC, typename Out>
int launch(const uint8_t* a, long long a_m, long long a_k, const uint8_t* as, long long as_m,
           long long as_g, const uint8_t* b, long long b_k, const uint8_t* bs, long long bs_g,
           const float* alpha, float alpha_val, Out* c, int M, int N, int K, int kc, double* part,
           int* counters, cudaStream_t st) {
  static bool done[kMaxDev] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDev || !done[dev]) {  // the largest slice's shared memory, once a device
    err = cudaFuncSetAttribute(gemm_fp4_decode<F, MB, VEC, Out>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem(MB, MAX_KC, F::G));
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDev) done[dev] = true;
  }
  const dim3 grid((N + tile(MB) - 1) / tile(MB), (K + kc - 1) / kc);
  gemm_fp4_decode<F, MB, VEC, Out><<<grid, THREADS, smem(MB, kc, F::G), st>>>(
      a, a_m, a_k, as, as_m, as_g, b, b_k, bs, bs_g, alpha, alpha_val, c, M, N, K, kc, part,
      counters);
  return (int)cudaGetLastError();
}

template <typename F, int MB, typename Out>
int launch_vec(const uint8_t* a, long long a_m, long long a_k, const uint8_t* as, long long as_m,
               long long as_g, const uint8_t* b, long long b_k, const uint8_t* bs, long long bs_g,
               const float* alpha, float alpha_val, Out* c, int M, int N, int K, int kc,
               double* part, int* counters, cudaStream_t st) {
  constexpr int C = cols(MB);
  if (aligned(b, C) && b_k % C == 0 && aligned(bs, C) && bs_g % C == 0 && N % C == 0)
    return launch<F, MB, true>(a, a_m, a_k, as, as_m, as_g, b, b_k, bs, bs_g, alpha, alpha_val, c,
                               M, N, K, kc, part, counters, st);
  return launch<F, MB, false>(a, a_m, a_k, as, as_m, as_g, b, b_k, bs, bs_g, alpha, alpha_val, c,
                              M, N, K, kc, part, counters, st);
}

// the decode kernel of format F for a'[m, kp] = a[m * a_m + kp * a_k]
// (packed, kp = k / 2) with scales as[m * as_m + g * as_g], the weight
// b[kp * b_k + n] with scales bs[g * bs_g + n]; alpha fp32 on the device,
// or alpha_val where alpha is null; c [M, N] bf16 or (out_f32) fp32.  M <= 16, K % G == 0, kc a multiple of G * WARPS and at most
// MAX_KC; part fp64 [ceil(K / kc), M, N] and counters int32 [ceil(N /
// tile(MB))] all zero (the kernel leaves them zero), MB = 4, 8 or 16, the
// least that holds M.  What it does not take returns cudaErrorInvalidValue.
template <typename F>
int run(const uint8_t* a, long long a_m, long long a_k, const uint8_t* as, long long as_m,
        long long as_g, const uint8_t* b, long long b_k, const uint8_t* bs, long long bs_g,
        const float* alpha, float alpha_val, void* c, int out_f32, int M, int N, int K, int kc,
        double* part, int* counters, cudaStream_t st) {
  if (M <= 0 || M > 16 || N <= 0 || K <= 0 || K % F::G || counters == nullptr || kc <= 0 ||
      kc % kc_gran<F>() || kc > MAX_KC)
    return (int)cudaErrorInvalidValue;
  auto rows = [&](auto* cp) {
    if (M <= 4)
      return launch_vec<F, 4>(a, a_m, a_k, as, as_m, as_g, b, b_k, bs, bs_g, alpha, alpha_val, cp, M, N, K,
                              kc, part, counters, st);
    if (M <= 8)
      return launch_vec<F, 8>(a, a_m, a_k, as, as_m, as_g, b, b_k, bs, bs_g, alpha, alpha_val, cp, M, N, K,
                              kc, part, counters, st);
    return launch_vec<F, 16>(a, a_m, a_k, as, as_m, as_g, b, b_k, bs, bs_g, alpha, alpha_val, cp, M, N, K,
                             kc, part, counters, st);
  };
  return out_f32 ? rows((float*)c) : rows((__nv_bfloat16*)c);
}

}  // namespace dec
}  // namespace
