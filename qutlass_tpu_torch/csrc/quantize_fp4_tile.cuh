// The tile of K1 (quantize_mx.cu) and K5 (quantize_nv.cu), the fused
// rotate + fp4 quantizers: one template on the format (qf4::Mx: 32-groups,
// e8m0 bytes, the clip mask; qf4::Nv: 16-groups, e4m3 bytes under a global
// scale read from device memory).
//
// Their bits are those of the first K1 / K5 design, whose device functions
// K16 and K17 share through common.cuh: each rotated value is one fp32
// fmaf chain over i = 0 .. rot-1 in ascending order (qt::rotate_elem's),
// and each group's QuEST sums are taken in the xor butterfly of
// qt::warp_sum / half_sum (offsets 16, 8, 4, 2, 1 for a 32-group; 8, 4,
// 2, 1 for a 16-group).
// ops/emulation.fused_quantize_{mx,nv}_ordered_plain write those orders
// out in plain PyTorch, and the tests hold these kernels to them bit for
// bit.
//
// What bounds them on the H100: instruction issue.  They read 2 bytes and
// write ~0.56 byte an element but do `rot` fp32 FMAs an element in an
// order that rules out the tensor cores; the FMA floor (rot 32) is about
// the byte bound's time.  The first design spent ~6 issue slots an FMA (two
// shared loads of bf16 and their conversions, an index), and walked each
// (row, 32-group) pair with a whole warp, one butterfly of five shuffles
// per element for each sum (tools/time_quantizers.py, on an H100 80GB HBM3
// at 700 W: without the rotation its K1 took 0.0165 of 0.0382 ms at (512,
// 4096)).  Here:
//   * a task is 32 columns (one MX group, two NV groups) of one row, held
//     by S = 32 / C lanes of C columns each: lane j holds columns j + S*t,
//     t < C.  So the first log2(C) butterfly steps (offsets 16 .. S) are
//     adds inside the thread, in the butterfly's order, and only log2(S)
//     are shuffles; the scale math runs once for C elements;
//   * x is converted to fp32 once, into shared memory; the rotation sits
//     in shared memory as fp32, ROT x ROT only, permuted so that a lane's
//     C columns of row i are contiguous: each FMA takes about a quarter of
//     a 16-byte shared load (the x value comes four at a time, broadcast
//     to the task's lanes), with the C chains independent;
//   * C = 16 (two lanes a task) on tiles of 32 rows at 64 registers, four
//     blocks an SM; at decode, C = 4 (eight lanes a task, shorter chains)
//     on tiles of 4 or 16 rows (C = 8 or 4 and 16- or 64-row tiles were
//     slower at (512, 4096); K1 takes 0.0121 ms there, the rotation ~30%);
//   * codes, scale bytes and mask bytes are staged in shared memory in the
//     output's orientation and leave as 4-byte words along the output's
//     contiguous axis (bytes only where that axis is ragged or unaligned:
//     rows % 4 != 0 in a K-major layout).
// One launch a call, no scratch, no host sync: a CUDA graph replays it.
#pragma once

#include "common.cuh"

namespace qf4 {

constexpr int TASK = 32;        // columns of a task
constexpr int WIDE_TR = 32;     // rows of a tile above 16 rows
constexpr int WIDE_C = 16;      // columns a lane there
constexpr int WIDE_TK = 128;    // columns of a tile there (at least the rotation)
constexpr int WIDE_MIN_BLOCKS = 4;  // __launch_bounds__' blocks an SM there, rotation <= 32
constexpr int WIDE_MIN_BLOCKS_BIG = 3;  // the same, rotation 64 and 128 (64 registers hold a
                                        // local array there)
constexpr int NARROW_C = 4;     // columns a lane, tiles of 4 and 16 rows
constexpr int NARROW_TK = 128;  // columns of such a tile (at least the rotation)
constexpr int XPAD = 4;         // floats after each x row in shared memory
constexpr int HPAD = 4;         // floats after each 32-column block of H

// staging pitch (bytes) of a tile row of `n` bytes: a multiple of 4, plus 4
__host__ __device__ constexpr int pitch(int n) { return ((n + 3) & ~3) + 4; }

// bytes to stage [n] x [tr] bytes K-major or [tr] x [n] row-major
__host__ __device__ constexpr int stage(int n, int tr) {
  return n * pitch(tr) > tr * pitch(n) ? n * pitch(tr) : tr * pitch(n);
}

// a tile of TR rows (4, 16 or WIDE_TR; the wide one above 16 rows)
template <int TR, int ROT>
struct Tile {
  static constexpr bool WIDE = TR > 16;
  static constexpr int C = WIDE ? WIDE_C : NARROW_C;
  static constexpr int S = TASK / C;                       // lanes a task
  static constexpr int TKB = WIDE ? WIDE_TK : NARROW_TK;
  static constexpr int TK = TKB > ROT ? TKB : ROT;         // whole rotation chunks
  static constexpr int THREADS = TR * (TK / TASK) * S;
  static constexpr int MIN_BLOCKS = !WIDE ? 1 : ROT <= 32 ? WIDE_MIN_BLOCKS : WIDE_MIN_BLOCKS_BIG;
  static constexpr int XP = TK + XPAD;
  // H: [ROT/32][ROT][32] (+ HPAD a block); ROT = 16: [16][16]
  static constexpr int HFLOATS = ROT >= 32 ? (ROT / 32) * (ROT * 32 + HPAD) : 16 * 16;
  static constexpr int XFLOATS = TR * XP;
  // staging of codes, then scale bytes, then mask bytes
  static constexpr int CB = stage(TK, TR), SB = stage(TK / 16, TR), MB = stage(TK / 8, TR);
  static constexpr int SMEM = 4 * (XFLOATS + HFLOATS) + CB + SB + MB;
};

// ---------------------------------------------------------------------------
// loads: the rotation and the x tile, to fp32 in shared memory
// ---------------------------------------------------------------------------

// 8 bf16 at p (16-byte aligned where vec) as 4 words, element 2u in the
// low half of word u
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* __restrict__ p, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned short* e = reinterpret_cast<const unsigned short*>(p);
  return make_uint4(e[0] | ((unsigned)e[1] << 16), e[2] | ((unsigned)e[3] << 16),
                    e[4] | ((unsigned)e[5] << 16), e[6] | ((unsigned)e[7] << 16));
}

// bf16 element u (0..7) of 8 loaded by load8, widened to fp32 exactly
__device__ __forceinline__ float widen(const uint4& w, int u) {
  const unsigned x = u < 2 ? w.x : u < 4 ? w.y : u < 6 ? w.z : w.w;
  return __uint_as_float(u & 1 ? x & 0xFFFF0000u : x << 16);
}

// h [ROT, ROT] bf16 -> hp.  ROT >= 32: element (i, c) of 32-column block
// b = c / 32 goes to hp[b * (ROT * 32 + HPAD) + i * 32 + j * C + t] with
// c % 32 = j + S * t.  ROT = 16: (i, c) -> hp[i * 16 + j * (C / 2) + t],
// c = j + S * t (both 16-column chunks of a task use it).
template <int ROT, int C, int THREADS>
__device__ __forceinline__ void load_rotation(float* __restrict__ hp,
                                              const __nv_bfloat16* __restrict__ h, int tid) {
  constexpr int S = TASK / C;
  const bool vec = (reinterpret_cast<uintptr_t>(h) & 15) == 0;
  for (int v = tid; v < ROT * ROT / 8; v += THREADS) {
    const int i = v / (ROT / 8), c0 = (v % (ROT / 8)) * 8;
    const uint4 w = load8(h + 8 * v, vec);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = c0 + u, cc = c % TASK, j = cc % S, t = cc / S;
      const int at = ROT >= 32 ? (c / TASK) * (ROT * TASK + HPAD) + i * TASK + j * C + t
                               : i * 16 + j * (C / 2) + t;
      hp[at] = widen(w, u);
    }
  }
}

// x rows r0 .. r0+TR-1, columns k0 .. k0+kw-1 -> x_s [TR][XP] fp32, zero
// elsewhere (kw is a multiple of 16, so a vector of 8 is all in or out)
template <int TR, int TK, int XP, int THREADS>
__device__ __forceinline__ void load_x(float* __restrict__ x_s, const __nv_bfloat16* __restrict__ x,
                                       int r0, int rows, int k, int k0, int kw, int tid) {
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  for (int v = tid; v < TR * TK / 8; v += THREADS) {
    const int rr = v / (TK / 8), cc = (v % (TK / 8)) * 8, row = r0 + rr;
    uint4 w = make_uint4(0, 0, 0, 0);
    if (row < rows && cc < kw) w = load8(x + (long long)row * k + k0 + cc, vec);
    float4* dst = reinterpret_cast<float4*>(x_s + rr * XP + cc);
    dst[0] = make_float4(widen(w, 0), widen(w, 1), widen(w, 2), widen(w, 3));
    dst[1] = make_float4(widen(w, 4), widen(w, 5), widen(w, 6), widen(w, 7));
  }
}

// ---------------------------------------------------------------------------
// the rotation: v[t] = column j + S*t of the task's 32, each one fmaf chain
// over i = 0 .. ROT-1 in ascending order from 0 (qt::rotate_elem's bits)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float part(const float4& a, int u) {
  return u == 0 ? a.x : u == 1 ? a.y : u == 2 ? a.z : a.w;
}

// xrow: the task's row in x_s at its first rotation chunk; hp: the task's
// 32-column block of the permuted rotation (ROT = 16: the whole of it)
template <int ROT, int C>
__device__ __forceinline__ void rotate_task(const float* __restrict__ xrow,
                                            const float* __restrict__ hp, int j, float (&v)[C]) {
#pragma unroll
  for (int t = 0; t < C; ++t) v[t] = 0.f;
  if constexpr (ROT == 16) {
    constexpr int H = C / 2;      // columns a lane in each 16-column chunk
#pragma unroll
    for (int i = 0; i < 16; i += 4) {
      const float4 xa = *reinterpret_cast<const float4*>(xrow + i);
      const float4 xb = *reinterpret_cast<const float4*>(xrow + 16 + i);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float hv[H];
        const float* hr = hp + (i + u) * 16 + j * H;
#pragma unroll
        for (int t = 0; t < H; t += 2) {
          const float2 p = *reinterpret_cast<const float2*>(hr + t);
          hv[t] = p.x;
          hv[t + 1] = p.y;
        }
#pragma unroll
        for (int t = 0; t < H; ++t) {
          v[t] = fmaf(part(xa, u), hv[t], v[t]);
          v[t + H] = fmaf(part(xb, u), hv[t], v[t + H]);
        }
      }
    }
  } else {
#pragma unroll 8
    for (int i = 0; i < ROT; i += 4) {
      const float4 xv = *reinterpret_cast<const float4*>(xrow + i);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float hv[C];
        const float* hr = hp + (i + u) * TASK + j * C;
#pragma unroll
        for (int t = 0; t < C; t += 4) {
          const float4 p = *reinterpret_cast<const float4*>(hr + t);
          hv[t] = p.x;
          hv[t + 1] = p.y;
          hv[t + 2] = p.z;
          hv[t + 3] = p.w;
        }
#pragma unroll
        for (int t = 0; t < C; ++t) v[t] = fmaf(part(xv, u), hv[t], v[t]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// group statistics in the xor butterfly's order
// ---------------------------------------------------------------------------

// Sum of one group held as N values a lane (columns j + S*t, t < N) over S
// lanes: the butterfly's steps of offset S*N/2 .. S are adds inside the
// thread (a[t] + a[t + o], element l plus element l ^ (S*o)), then offsets
// S/2 .. 1 are shuffles among the task's lanes.  Every lane ends with the
// sum qt::warp_sum (N * S = 32) or qt::half_sum (16) gives, bit for bit.
template <int O>
__device__ __forceinline__ void tree_add(float* b) {   // b[t] += b[t + O], O/2, .. 1
  if constexpr (O >= 1) {
#pragma unroll
    for (int t = 0; t < O; ++t) b[t] = __fadd_rn(b[t], b[t + O]);
    tree_add<O / 2>(b);
  }
}

template <int N, int S>
__device__ __forceinline__ float bfly_sum(const float* a) {
  float b[N];
#pragma unroll
  for (int t = 0; t < N; ++t) b[t] = a[t];
  tree_add<N / 2>(b);
  float s = b[0];
#pragma unroll
  for (int o = S / 2; o >= 1; o /= 2) s = __fadd_rn(s, __shfl_xor_sync(0xFFFFFFFFu, s, o));
  return s;
}

// largest |a| of one group (fmaxf, as qt::warp_max: the order is free)
template <int N, int S>
__device__ __forceinline__ float group_amax(const float* a) {
  float m = fabsf(a[0]);
#pragma unroll
  for (int t = 1; t < N; ++t) m = fmaxf(m, fabsf(a[t]));
#pragma unroll
  for (int o = S / 2; o >= 1; o /= 2) m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, o));
  return m;
}

template <int N, int S>
__device__ __forceinline__ void moments(const float* a, float& s1, float& s2) {
  float sq[N];
#pragma unroll
  for (int t = 0; t < N; ++t) sq[t] = __fmul_rn(a[t], a[t]);
  s1 = bfly_sum<N, S>(a);
  s2 = bfly_sum<N, S>(sq);
}

// ---------------------------------------------------------------------------
// the formats: a task's scale bytes and codes from its rotated values
// ---------------------------------------------------------------------------

// MXFP4: one 32-group a task; qt::group_scale_byte's arithmetic on the
// butterfly's sums, qt::group_q's scaled value, the clip mask's bits
struct Mx {
  static constexpr int G = 32;
  static constexpr bool MASK = true;

  template <int C>
  __device__ __forceinline__ static unsigned encode(const float (&v)[C], int j, int method,
                                                    float, int (&byte)[1], int (&code)[C]) {
    constexpr int S = TASK / C;
    float scale;
    if (method == 0) {
      float s1, s2;
      moments<C, S>(v, s1, s2);
      const float mean = __fmul_rn(s1, 0.03125f);
      const float var = __fsub_rn(__fmul_rn(s2, 0.03125f), __fmul_rn(mean, mean));
      scale = var >= 0.f ? __fadd_rn(__fmul_rn(__fsqrt_rn(var), qt::kQuestConst), qt::kScaleEps)
                         : 1.0f;
    } else {
      scale = __fadd_rn(group_amax<C, S>(v), qt::kScaleEps);
    }
    byte[0] = (__float_as_int(scale) & 0x7F800000) >> 23;
    unsigned keep = 0;    // bit l: |q| < 6 at column l of the task
#pragma unroll
    for (int t = 0; t < C; ++t) {
      const float q = qt::group_q(v[t], byte[0], method);
      code[t] = qt::e2m1_code(q);
      keep |= (unsigned)(fabsf(q) < 6.0f) << (j + S * t);
    }
#pragma unroll
    for (int o = S / 2; o >= 1; o /= 2) keep |= __shfl_xor_sync(0xFFFFFFFFu, keep, o);
    return keep;
  }
};

// NVFP4: two 16-groups a task (t < C/2 and t >= C/2); qt::nv_group_byte's
// arithmetic on the butterfly's sums, qt::nv_mul's multiplier
struct Nv {
  static constexpr int G = 16;
  static constexpr bool MASK = false;

  template <int C>
  __device__ __forceinline__ static unsigned encode(const float (&v)[C], int, int method,
                                                    float gs, int (&byte)[2], int (&code)[C]) {
    constexpr int S = TASK / C, H = C / 2;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float* a = v + u * H;
      if (method == 1) {
        byte[u] = qt::e4m3_byte(__fmul_rn(gs, __fmul_rn(group_amax<H, S>(a), qt::kSixth)));
      } else {
        float s1, s2;
        moments<H, S>(a, s1, s2);
        const float mean = __fmul_rn(s1, 0.0625f);
        const float var = __fsub_rn(__fmul_rn(s2, 0.0625f), __fmul_rn(mean, mean));
        byte[u] = !(var >= 0.f) ? 0xFF
                                : qt::e4m3_byte(__fadd_rn(__fmul_rn(__fsqrt_rn(var), qt::kQuestConst),
                                                          qt::kScaleEps));
      }
      const float mul = qt::nv_mul(byte[u], method, gs);
#pragma unroll
      for (int t = 0; t < H; ++t) code[u * H + t] = qt::e2m1_code(__fmul_rn(a[t], mul));
    }
    return 0u;
  }
};

// ---------------------------------------------------------------------------
// stores: a staged byte tile to device memory in 4-byte words
// ---------------------------------------------------------------------------

// dst[a * sa + b] for a < na, b < nb, from word(a, w) (bytes 4w .. 4w+3 of
// row a) and byte(a, b); consecutive threads take consecutive words of a
// row.  Words where `vec` (dst and sa 4-byte aligned) and the word is
// whole, bytes elsewhere.
template <int NW, int THREADS, class W, class B>
__device__ __forceinline__ void store_words(uint8_t* __restrict__ dst, long long sa, int na,
                                            int nb, bool vec, int tid, W word, B byte) {
  for (int i = tid; i < na * NW; i += THREADS) {
    const int a = i / NW, b = (i % NW) * 4;
    if (b >= nb) continue;
    uint8_t* p = dst + a * sa + b;
    if (vec && b + 4 <= nb) {
      *reinterpret_cast<unsigned*>(p) = word(a, b >> 2);
    } else {
      for (int u = 0; u < 4 && b + u < nb; ++u) p[u] = byte(a, b + u);
    }
  }
}

__device__ __forceinline__ bool aligned4(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 3) == 0;
}

// two bytes of e2m1 codes each in 0..15 -> their packed byte, for the four
// byte pairs of u0 (low half) and u1 (high half)
__device__ __forceinline__ unsigned pack_pairs(unsigned u0, unsigned u1) {
  const unsigned a = u0 | (u0 >> 4), b = u1 | (u1 >> 4);
  return (a & 0xFFu) | ((a >> 8) & 0xFF00u) | ((b & 0xFFu) << 16) | ((b << 8) & 0xFF000000u);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// layout: 0 = row-major packed [rows, K/2], 1 = K-major packed [K/2, rows],
// 2 = K-major codes [K, rows] (MX).  Scale byte (row, g) goes to
// s[g * s_sg + row * s_sr], mask byte (row, b) to mask[b * m_sj + row * m_sr]
// (MX, where mask is not null); gs_ptr: the NV global scale.
template <class F, int TR, int ROT>
__global__ void __launch_bounds__(Tile<TR, ROT>::THREADS, Tile<TR, ROT>::MIN_BLOCKS)
quantize_fp4(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ h,
             const float* __restrict__ gs_ptr, uint8_t* __restrict__ q, uint8_t* __restrict__ s,
             uint8_t* __restrict__ mask, int rows, int k, int method, int layout, long long s_sg,
             long long s_sr, long long m_sj, long long m_sr) {
  using T = Tile<TR, ROT>;
  constexpr int C = T::C, S = T::S, TK = T::TK, THREADS = T::THREADS, G = F::G;
  constexpr int NG = TASK / G;                 // groups a task
  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;
  float* h_s = x_s + T::XFLOATS;
  uint8_t* c_s = reinterpret_cast<uint8_t*>(h_s + T::HFLOATS);
  uint8_t* s_s = c_s + T::CB;
  uint8_t* m_s = s_s + T::SB;

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * TR, k0 = blockIdx.y * TK;
  const int kw = min(TK, k - k0), nr = min(TR, rows - r0);
  const bool rm = layout == 0;
  const float gs = gs_ptr != nullptr ? *gs_ptr : 0.f;

  load_rotation<ROT, C, THREADS>(h_s, h, tid);
  load_x<TR, TK, T::XP, THREADS>(x_s, x, r0, rows, k, k0, kw, tid);
  __syncthreads();

  // task (r, g): tile row r, columns 32g .. 32g+31; a warp's tasks share g
  const int task = tid / S, j = tid % S;
  const int r = task % TR, g = task / TR, c0 = g * TASK;
  const int chunk = ROT >= 32 ? (c0 / ROT) * ROT : c0;
  const float* hp = h_s + (ROT >= 32 ? ((c0 % ROT) / TASK) * (ROT * TASK + HPAD) : 0);
  float v[C];
  rotate_task<ROT, C>(x_s + r * T::XP + chunk, hp, j, v);

  int byte[NG], code[C];
  const unsigned keep = F::template encode<C>(v, j, method, gs, byte, code);

  // stage: [col][TR] K-major, or [TR][col] row-major (layout 0)
#pragma unroll
  for (int t = 0; t < C; ++t) {
    const int col = c0 + j + S * t;
    c_s[rm ? r * pitch(TK) + col : col * pitch(TR) + r] = (uint8_t)code[t];
  }
#pragma unroll
  for (int u = 0; u < NG; ++u) {   // byte u by lane u % S (constant indices keep byte[] in registers)
    const int gi = g * NG + u;
    if (u % S == j) s_s[rm ? r * pitch(TK / G) + gi : gi * pitch(TR) + r] = (uint8_t)byte[u];
  }
  if (F::MASK) {
    for (int u = j; u < TASK / 8; u += S) {
      const int bi = g * (TASK / 8) + u;
      m_s[rm ? r * pitch(TK / 8) + bi : bi * pitch(TR) + r] = (uint8_t)(keep >> (8 * u));
    }
  }
  __syncthreads();

  auto u32 = [](const uint8_t* p) { return *reinterpret_cast<const unsigned*>(p); };
  if (rm) {
    // codes [rows, K/2]: a = row, b = packed byte
    uint8_t* dq = q + (long long)r0 * (k / 2) + k0 / 2;
    store_words<TK / 8, THREADS>(
        dq, k / 2, nr, kw / 2, aligned4(dq) && (k / 2) % 4 == 0, tid,
        [&](int a, int w) {
          const uint8_t* p = c_s + a * pitch(TK) + 8 * w;
          return pack_pairs(u32(p), u32(p + 4));
        },
        [&](int a, int b) {
          const uint8_t* p = c_s + a * pitch(TK) + 2 * b;
          return (uint8_t)(p[0] | (p[1] << 4));
        });
    uint8_t* ds = s + (long long)(k0 / G) * s_sg + (long long)r0 * s_sr;
    store_words<(TK / G + 3) / 4, THREADS>(
        ds, s_sr, nr, kw / G, s_sg == 1 && aligned4(ds) && s_sr % 4 == 0, tid,
        [&](int a, int w) { return u32(s_s + a * pitch(TK / G) + 4 * w); },
        [&](int a, int b) { return s_s[a * pitch(TK / G) + b]; });
    if (F::MASK && mask != nullptr) {
      uint8_t* dm = mask + (long long)(k0 / 8) * m_sj + (long long)r0 * m_sr;
      store_words<(TK / 8 + 3) / 4, THREADS>(
          dm, m_sr, nr, kw / 8, m_sj == 1 && aligned4(dm) && m_sr % 4 == 0, tid,
          [&](int a, int w) { return u32(m_s + a * pitch(TK / 8) + 4 * w); },
          [&](int a, int b) { return m_s[a * pitch(TK / 8) + b]; });
    }
  } else {
    // K-major: a = packed byte (layout 1) or code (layout 2), b = row
    const bool vrows = rows % 4 == 0;
    if (layout == 1) {
      uint8_t* dq = q + (long long)(k0 / 2) * rows + r0;
      store_words<(TR + 3) / 4, THREADS>(
          dq, rows, kw / 2, nr, vrows && aligned4(dq), tid,
          [&](int a, int w) {
            return u32(c_s + 2 * a * pitch(TR) + 4 * w) |
                   (u32(c_s + (2 * a + 1) * pitch(TR) + 4 * w) << 4);
          },
          [&](int a, int b) {
            return (uint8_t)(c_s[2 * a * pitch(TR) + b] | (c_s[(2 * a + 1) * pitch(TR) + b] << 4));
          });
    } else {
      uint8_t* dq = q + (long long)k0 * rows + r0;
      store_words<(TR + 3) / 4, THREADS>(
          dq, rows, kw, nr, vrows && aligned4(dq), tid,
          [&](int a, int w) { return u32(c_s + a * pitch(TR) + 4 * w); },
          [&](int a, int b) { return c_s[a * pitch(TR) + b]; });
    }
    uint8_t* ds = s + (long long)(k0 / G) * s_sg + (long long)r0 * s_sr;
    store_words<(TR + 3) / 4, THREADS>(
        ds, s_sg, kw / G, nr, s_sr == 1 && vrows && aligned4(ds) && s_sg % 4 == 0, tid,
        [&](int a, int w) { return u32(s_s + a * pitch(TR) + 4 * w); },
        [&](int a, int b) { return s_s[a * pitch(TR) + b]; });
    if (F::MASK && mask != nullptr) {
      uint8_t* dm = mask + (long long)(k0 / 8) * m_sj + (long long)r0 * m_sr;
      store_words<(TR + 3) / 4, THREADS>(
          dm, m_sj, kw / 8, nr, m_sr == 1 && vrows && aligned4(dm) && m_sj % 4 == 0, tid,
          [&](int a, int w) { return u32(m_s + a * pitch(TR) + 4 * w); },
          [&](int a, int b) { return m_s[a * pitch(TR) + b]; });
    }
  }
}

template <class F, int TR, int ROT>
cudaError_t launch_tile(const __nv_bfloat16* x, const __nv_bfloat16* h, const float* gs,
                        uint8_t* q, uint8_t* s, uint8_t* mask, int rows, int k, int method,
                        int layout, long long s_sg, long long s_sr, long long m_sj,
                        long long m_sr, cudaStream_t st) {
  using T = Tile<TR, ROT>;
  auto kern = quantize_fp4<F, TR, ROT>;
  if (T::SMEM > 48 * 1024) {   // ROT = 128: above the default of dynamic shared memory
    const cudaError_t set =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (set != cudaSuccess) return set;
  }
  const dim3 grid((rows + TR - 1) / TR, (k + T::TK - 1) / T::TK);
  kern<<<grid, T::THREADS, T::SMEM, st>>>(x, h, gs, q, s, mask, rows, k, method, layout, s_sg,
                                           s_sr, m_sj, m_sr);
  return cudaGetLastError();
}

// host: the tile for `rows` (4, 16 or WIDE_TR rows) and the rotation size (16,
// 32, 64 or 128; the wrapper checks)
template <class F, int TR, class... A>
cudaError_t launch_rot(int rot, A... args) {
  switch (rot) {
    case 16: return launch_tile<F, TR, 16>(args...);
    case 32: return launch_tile<F, TR, 32>(args...);
    case 64: return launch_tile<F, TR, 64>(args...);
    case 128: return launch_tile<F, TR, 128>(args...);
    default: return cudaErrorInvalidValue;
  }
}

template <class F>
cudaError_t launch(const __nv_bfloat16* x, const __nv_bfloat16* h, const float* gs, uint8_t* q,
                   uint8_t* s, uint8_t* mask, int rows, int k, int rot, int method, int layout,
                   long long s_sg, long long s_sr, long long m_sj, long long m_sr,
                   cudaStream_t st) {
  if (rows <= 4)
    return launch_rot<F, 4>(rot, x, h, gs, q, s, mask, rows, k, method, layout, s_sg, s_sr, m_sj,
                            m_sr, st);
  if (rows <= 16)
    return launch_rot<F, 16>(rot, x, h, gs, q, s, mask, rows, k, method, layout, s_sg, s_sr,
                             m_sj, m_sr, st);
  return launch_rot<F, WIDE_TR>(rot, x, h, gs, q, s, mask, rows, k, method, layout, s_sg, s_sr,
                                m_sj, m_sr, st);
}

}  // namespace qf4
