// The tile shared by K2 (quantize_mx_int8.cu) and K6 (quantize_nv_int8.cu),
// the int8-encoding activation quantizers of every W4A4 linear.
//
// Both write a' int8 [K, rows] (K-major), a per-row fp32 scale and the
// group scale bytes [K/G, rows], and each a' needs a maximum over its whole
// row.  The design, shared here:
//   * pass A runs on a grid of (row tiles) x (128-column K chunks), so a
//     decode call (rows <= 16, one row tile) gets K/128 blocks: 32 at
//     K = 4096, 96 at K = 12288;
//   * a row tile is 16 rows where rows <= 16 and 32 above, so at prefill
//     each k-row of a block's a' tile is one full 32-byte sector;
//   * each lane keeps its column of the rotation in registers (RotCol):
//     one shared-memory load (of two x values) per two FMAs, in the FMA
//     order of qt::rotate_elem, so the rotated values are its bits;
//   * pass A rotates, quantizes, writes the scale bytes and each element's
//     signed e2m1 mantissa m2 (-12..12) into the a' buffer itself, and
//     folds the tile's row maxima into a scratch [rows] with an integer
//     atomicMax (exact, so the order of the blocks does not matter);
//   * the encode launch (encode_flat) turns m2 into a' with the finished
//     row maximum, elementwise over [K, rows] with 16-byte accesses; its
//     last block to finish (an atomicAdd on the counter after the row
//     maxima) zeroes the row maxima and the counter.
// So a call is two launches on a scratch that is zero between calls: no
// memset and no host sync, and a CUDA graph can replay it.  Two other
// forms were timed against it at rows = 4 (tools/time_int8_quantizers.py,
// NVIDIA H100 80GB HBM3 at 700 W; K2 ms at K = 4096 / 12288): a memset
// before the same two launches, 0.0097 / 0.0096, and one launch whose
// last block to arrive encodes all of [K, rows], 0.0117 / 0.0229 (one
// block's pass over K x 4 bytes costs more than a launch), against
// 0.0087 / 0.0089 for this one.
#pragma once

#include "common.cuh"

namespace qi8 {

constexpr int TK = 128;        // columns of a block's K chunk
constexpr int THREADS = 256;   // 8 warps: warp w owns the 32 columns (w & 3)
constexpr int VEC = 16;        // bytes a thread moves per step of the encode
constexpr int NARROW_ROWS = 16;  // rows at or below which a row tile is 16 rows

// the rotation column `hc` of h [ROT, ROT] in registers, in bf16 pairs
template <int ROT>
struct RotCol {
  __nv_bfloat162 h[ROT / 2];

  __device__ __forceinline__ void load(const __nv_bfloat16* __restrict__ hm, int hc) {
#pragma unroll
    for (int i = 0; i < ROT / 2; ++i) {
      h[i].x = hm[(2 * i) * ROT + hc];
      h[i].y = hm[(2 * i + 1) * ROT + hc];
    }
  }

  // sum over i of x[c0 + i] * h[i][hc], i = 0 .. ROT-1 in order: the bits
  // of qt::rotate_elem.  xc0 points at x[c0] in shared memory (4-byte
  // aligned: c0 is a multiple of ROT).
  __device__ __forceinline__ float rotate(const __nv_bfloat16* xc0) const {
    const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(xc0);
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < ROT / 2; ++i) {
      const __nv_bfloat162 xx = xp[i];
      v = fmaf(__bfloat162float(xx.x), __bfloat162float(h[i].x), v);
      v = fmaf(__bfloat162float(xx.y), __bfloat162float(h[i].y), v);
    }
    return v;
  }
};

// x rows r0 .. r0+TR-1, columns k0 .. k0+kw-1 -> x_s, zero elsewhere
// (kw is a multiple of 16, so a 16-byte vector is all in or all out)
template <int TR>
__device__ __forceinline__ void load_x_tile(__nv_bfloat16 (*x_s)[TK],
                                            const __nv_bfloat16* __restrict__ x, int r0,
                                            int rows, int k, int k0, int kw, int tid) {
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
#pragma unroll
  for (int j = 0; j < TR * (TK / 8) / THREADS; ++j) {
    const int i = tid + j * THREADS, rr = i / (TK / 8), cc = (i % (TK / 8)) * 8;
    const int row = r0 + rr;
    const bool in = row < rows && cc < kw;
    const __nv_bfloat16* src = x + (long long)row * k + k0 + cc;
    int4 v = make_int4(0, 0, 0, 0);
    if (in && vec) {
      v = __ldg(reinterpret_cast<const int4*>(src));
    } else if (in) {
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
      for (int t = 0; t < 8; ++t) e[t] = src[t];
    }
    *reinterpret_cast<int4*>(&x_s[rr][cc]) = v;
  }
}

// a[e] = enc(a[e], e / rows, e % rows) over e in [0, n), 16 bytes a step;
// thread `t` of `nt` takes steps t, t + nt, ...  a is 16-byte aligned and
// n a multiple of 16 (K is a multiple of 16).
template <class Enc>
__device__ __forceinline__ void encode_flat(int8_t* a, long long n, int rows, long long t,
                                            long long nt, Enc enc) {
  for (long long v = t; v * VEC < n; v += nt) {
    const long long e0 = v * VEC;
    int4* p = reinterpret_cast<int4*>(a + e0);
    const int4 w = *p;
    unsigned int wd[4] = {(unsigned int)w.x, (unsigned int)w.y, (unsigned int)w.z,
                          (unsigned int)w.w};
    int kk = (int)(e0 / rows), r = (int)(e0 - (long long)kk * rows);
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // bytes by shifts: no local-memory copy of w
      unsigned int out = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int m2 = (int)(signed char)((wd[q] >> (8 * b)) & 0xFFu);
        out |= ((unsigned int)enc(m2, kk, r) & 0xFFu) << (8 * b);
        if (++r == rows) {
          r = 0;
          ++kk;
        }
      }
      wd[q] = out;
    }
    *p = make_int4((int)wd[0], (int)wd[1], (int)wd[2], (int)wd[3]);
  }
}

// a block's a' tile a_s [TK][TR + 4] (k-rows of TR bytes) -> a [K, rows]:
// consecutive threads on consecutive rows of one k-row
template <int TR>
__device__ __forceinline__ void store_a_tile(int8_t* __restrict__ a, int8_t (*a_s)[TR + 4],
                                             int r0, int nr, int rows, int k0, int kw, int tid) {
  for (int i = tid; i < kw * TR; i += THREADS) {
    const int kk = i / TR, rr = i % TR;
    if (rr < nr) a[(long long)(k0 + kk) * rows + r0 + rr] = a_s[kk][rr];
  }
}

// the encode launch's last block to arrive (an atomicAdd on `counter`)
// zeroes the row maxima [rows] and the counter for the next call; every
// block has read the maxima it needed before it arrives
__device__ __forceinline__ void reset_when_last(int* vals, int* counter, int rows) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  for (int r = threadIdx.x; r < rows; r += THREADS) vals[r] = 0;
  if (threadIdx.x == 0) *counter = 0;
}

// blocks of the encode launch: 16 bytes a thread, at most 8 blocks an SM
// (a grid-stride loop above)
inline int encode_blocks(int rows, int k) {
  const long long steps = ((long long)k * rows / VEC + THREADS - 1) / THREADS;
  return (int)(steps < 132 * 8 ? steps : 132 * 8);
}

// host: launch pass A's template for `rows` and `rot`.  L is a class
// template with `template <int TR, int ROT> static cudaError_t run(...)`;
// rot is 16, 32, 64 or 128 (the wrapper checks).
template <int TR, template <int, int> class L, class... A>
cudaError_t dispatch_rot(int rot, A... args) {
  switch (rot) {
    case 16: return L<TR, 16>::run(args...);
    case 32: return L<TR, 32>::run(args...);
    case 64: return L<TR, 64>::run(args...);
    case 128: return L<TR, 128>::run(args...);
    default: return cudaErrorInvalidValue;
  }
}

template <template <int, int> class L, class... A>
cudaError_t dispatch(int rows, int rot, A... args) {
  return rows <= NARROW_ROWS ? dispatch_rot<16, L>(rot, args...) : dispatch_rot<32, L>(rot, args...);
}

}  // namespace qi8
