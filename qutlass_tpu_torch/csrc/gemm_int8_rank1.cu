// K3 gemm_int8_rank1: the int8 evaluator's GEMM,
//   C[m, n] = out( float(sum_k a'[m, k] * b'[n, k]) * (sa[m] * alpha) * sb[n] ),
// out = bf16 (round to nearest even) or fp32 (no rounding).
//
// Replaces the XLA int8 dot plus rank-1 epilogue of
// qutlass_tpu/ops/int8path.py:matmul_mxf4_bf16_int8{,_kmajor,_kk}
// (:133-180); the JAX package leaves it to XLA, the H100 needs it by hand:
// torch._int_mm refuses M <= 16, which is every decode step, and would
// leave the epilogue as a second pass over [M, N] in fp32.
//
// Operands are logical views a'[M, K] and b'[N, K] given by strides, so
// the main path's K-major activation ([K, M]), weights stored [N, K] or
// [K, N] (the NV path's "kk" order) and the QAT backward's row-major
// operands share the code.  The launcher picks one of two kernels by M:
//
// Decode, M <= 16 (gemm_decode): bound by the weight bytes (one byte per
// MAC).  The roles are swapped: 16 weight rows fill the m16n8k32 MMA's A
// side and the tokens its n8 side.  Each block owns 64 weight rows (128
// for [K, N] weights) and one slice of K (split-K, so that the grid covers
// the SMs several times over even at N = 1024); it stages its slice of the
// activation once, transposed to [m][k], in shared memory, after it has
// started its first weight loads.  [N, K] weights stream from device
// memory straight into the MMA registers in 16-byte loads, 256 bytes of K
// a row in flight while the previous 256 are multiplied, with no barrier
// in the loop.  [K, N] weights are read as 128-byte runs of a k-row, the
// 4x4 byte blocks transposed in registers (__byte_perm), and stored to a
// swizzled double-buffered [n][k] tile, two batches of 128 bytes of K in
// flight, one barrier a batch.  A 64-byte step of K feeds two MMAs:
// thread (g, t) holds bytes [16t, 16t + 16) of its rows, and the MMA's
// logical k order is a fixed permutation of them, the same for both
// operands, which an integer sum does not see.  Each block writes its
// int32 partial sums to a workspace; the last block of a column of splits
// to arrive (a per-tile counter, which it resets) adds them and runs the
// epilogue, in one launch and with no host sync.
//
// Prefill, M > 16 (gemm_prefill): bound by the int8 tensor-core rate and,
// at these tile sizes, by the L2 traffic of the operand tiles.  128 x BN
// output tiles (BN = 256 when both operands are K-contiguous and the grid
// still fills the card, else 128), two warpgroups each issuing
// wgmma.m64nBNk32.s32.s8.s8 from 128-byte-swizzled shared memory, a ring
// of 128 bytes of K a stage: K-contiguous operands arrive by 16-byte
// cp.async straight into their stage; K-major ones ([K, M] activations,
// [K, N] weights) arrive the same way into a raw ring as they lie, and
// each tile is transposed one stage ahead, shared memory to registers to
// shared memory (4x4 byte blocks by __byte_perm), since 8-bit wgmma takes
// only K-major operands.
//
// Exactness: int32 sums are exact (|a'|, |b'| <= 127 and the repo's K keep
// |sum| < 2^31) and integer addition is associative, so any split and any
// order give the same bits; the epilogue multiplies in the JAX op's order
// with round-to-nearest intrinsics (no FMA: --fmad=false).
#include "common.cuh"
#include "wgmma_s8.cuh"

namespace {

using wgs8::swz;
using wgs8::transpose4x4;
using wgs8::wgmma_desc;

constexpr int kMaxDev = 64;

__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16 bytes from device memory, not kept in L1 (each weight byte is read once)
__device__ __forceinline__ uint4 ld_stream(const int8_t* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// The 4 k-rows k..k+3 of the 16 columns r..r+15 of a K-major logical [R, K]
// operand (element (r, k) at p[r * s_r + k * s_k]; s_r == 1 when `vec`),
// zero outside r < R and k < kmax.  vec: one 16-byte load per k-row (the
// host checks alignment, s_k % 16 and R % 16); else byte loads.
__device__ __forceinline__ void load_4x16(uint4 (&v)[4], const int8_t* __restrict__ p,
                                          long long s_r, long long s_k, int r, int R, int k,
                                          int kmax, bool vec) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kj = k + j;
    if (vec) {
      v[j] = (kj < kmax && r < R) ? ld_stream(p + (long long)kj * s_k + r) : make_uint4(0, 0, 0, 0);
    } else {
      uint32_t w[4] = {0, 0, 0, 0};
      if (kj < kmax) {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (r + i < R)
            w[i >> 2] |= (uint32_t)(uint8_t)p[(long long)(r + i) * s_r + (long long)kj * s_k]
                         << (8 * (i & 3));
      }
      v[j] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// o[i] = the 4 bytes k..k+3 of column r + i, from load_4x16's rows
__device__ __forceinline__ void transpose_4x16(const uint4 (&v)[4], uint32_t (&o)[16]) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
    transpose4x4(word(v[0], c), word(v[1], c), word(v[2], c), word(v[3], c), &o[4 * c]);
}

__device__ __forceinline__ float rank1(int acc, float sa_alpha, float sbn) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), sa_alpha), sbn);
}

__device__ __forceinline__ void put(void* c, int out_f32, long long i, float y) {
  if (out_f32)
    static_cast<float*>(c)[i] = y;
  else
    static_cast<__nv_bfloat16*>(c)[i] = __float2bfloat16_rn(y);
}

// C[i], C[i + 1]; one 4- or 8-byte store when i is even (the host passes
// `pair` when N is even, so i even means the pair is aligned)
__device__ __forceinline__ void put2(void* c, int out_f32, long long i, float y0, float y1,
                                     bool pair) {
  if (pair && (i & 1) == 0) {
    if (out_f32)
      *reinterpret_cast<float2*>(static_cast<float*>(c) + i) = make_float2(y0, y1);
    else
      *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(c) + i) =
          __halves2bfloat162(__float2bfloat16_rn(y0), __float2bfloat16_rn(y1));
  } else {
    put(c, out_f32, i, y0);
    put(c, out_f32, i + 1, y1);
  }
}

// ---------------------------------------------------------------------------
// decode: M <= 16, split-K over weight rows streamed into the MMA registers
// ---------------------------------------------------------------------------

namespace dec {
constexpr int MROWS = 16;         // staged activation rows (tokens), zero beyond M
constexpr int BATCH = 256;        // [N, K]: bytes of K a row per batch (4 steps of 64)
constexpr int KK_BATCH = 128;     // [K, N]: k-rows a batch
constexpr int KK_STRIDE = 192;    // [n][k] tile row: 128 B of K + 64 (reads conflict-free)
constexpr int MAX_KC = 2048;

__host__ __device__ constexpr int rows(bool kk) { return kk ? 128 : 64; }  // weight rows a block
__host__ __device__ constexpr int threads(bool kk) { return 2 * rows(kk); }  // 16 rows a warp
__host__ __device__ constexpr int act_stride(int kc) { return kc + 64; }
__host__ __device__ constexpr size_t smem(int kc, bool kk) {
  return (size_t)MROWS * act_stride(kc) + (kk ? 2 * rows(kk) * KK_STRIDE : 0);
}
}  // namespace dec

// The block's activation slice a'[0..M, kbeg..kend) into act[m][k - kbeg]
// (row stride dec::act_stride(kc)), zero elsewhere.  mode 1: row-major,
// 16-byte copies; mode 2: K-major with M % 4 == 0, word loads transposed in
// registers; mode 0: bytes.
__device__ __forceinline__ void stage_activation(int8_t* act, int stride, const int8_t* __restrict__ a,
                                                 long long a_sm, long long a_sk, int M, int kbeg,
                                                 int kend, int mode, int tid, int nthr) {
  for (int i = tid; i < dec::MROWS * stride / 16; i += nthr)
    reinterpret_cast<uint4*>(act)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const int kw = kend - kbeg;
  if (mode == 1) {
    const int chunks = kw / 16;
    for (int i = tid; i < M * chunks; i += nthr) {
      const int m = i / chunks, ch = i % chunks;
      *reinterpret_cast<uint4*>(act + m * stride + 16 * ch) =
          *reinterpret_cast<const uint4*>(a + m * a_sm + kbeg + 16 * ch);
    }
  } else if (mode == 2) {
    const int mg = M / 4;
    for (int i = tid; i < (kw / 4) * mg; i += nthr) {
      const int k4 = i / mg, m4 = i % mg;
      const int8_t* p = a + (long long)(kbeg + 4 * k4) * a_sk + 4 * m4;
      uint32_t o[4];
      transpose4x4(*reinterpret_cast<const uint32_t*>(p),
                   *reinterpret_cast<const uint32_t*>(p + a_sk),
                   *reinterpret_cast<const uint32_t*>(p + 2 * a_sk),
                   *reinterpret_cast<const uint32_t*>(p + 3 * a_sk), o);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(act + (4 * m4 + j) * stride + 4 * k4) = o[j];
    }
  } else {
    for (int i = tid; i < M * kw; i += nthr) {
      const int m = a_sk == 1 ? i / kw : i % M, k = a_sk == 1 ? i % kw : i / M;
      act[m * stride + k] = a[(long long)m * a_sm + (long long)(kbeg + k) * a_sk];
    }
  }
}

// two MMAs over a 64-byte step: A = weight rows (g, g + 8), B = token g (and
// g + 8 when NT == 2); the step's logical k order is [16t, 16t + 16) per thread
template <int NT>
__device__ __forceinline__ void step64(int (&acc)[NT][4], const uint4& w0, const uint4& w1,
                                       const int8_t* act_g, int stride) {
  const uint4 x0 = *reinterpret_cast<const uint4*>(act_g);
  mma_s8(acc[0], w0.x, w1.x, w0.y, w1.y, x0.x, x0.y);
  mma_s8(acc[0], w0.z, w1.z, w0.w, w1.w, x0.z, x0.w);
  if constexpr (NT == 2) {
    const uint4 x1 = *reinterpret_cast<const uint4*>(act_g + 8 * stride);
    mma_s8(acc[1], w0.x, w1.x, w0.y, w1.y, x1.x, x1.y);
    mma_s8(acc[1], w0.z, w1.z, w0.w, w1.w, x1.z, x1.w);
  }
}

template <bool B_KMAJOR, int NT>
__global__ void __launch_bounds__(dec::threads(B_KMAJOR))
gemm_decode(const int8_t* __restrict__ a, long long a_sm, long long a_sk, int a_mode,
            const int8_t* __restrict__ b, long long b_sn, long long b_sk, int b_vec,
            const float* __restrict__ sa, const float* __restrict__ sb, float alpha,
            void* __restrict__ c, int out_f32, int M, int N, int K, int kc,
            int* __restrict__ part, int* __restrict__ counters) {
  constexpr int ROWS = dec::rows(B_KMAJOR), NTHR = dec::threads(B_KMAJOR);
  extern __shared__ __align__(16) int8_t smem[];
  const int stride = dec::act_stride(kc);
  int8_t* act = smem;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * ROWS, split = blockIdx.y, splits = gridDim.y;
  const int kbeg = split * kc, kend = min(K, kbeg + kc);

  int acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
  const int8_t* act_g = act + g * stride + 16 * t;

  if constexpr (!B_KMAJOR) {
    // [N, K] weights (b_sk == 1): rows n0 + 16 warp + g and + 8 straight
    // into registers, one batch in flight behind the one being multiplied
    const int r0 = n0 + warp * 16 + g, r1 = r0 + 8;
    const int8_t* p0 = b + (long long)min(r0, N - 1) * b_sn + 16 * t;
    const int8_t* p1 = b + (long long)min(r1, N - 1) * b_sn + 16 * t;
    const bool v0 = r0 < N, v1 = r1 < N;
    uint4 c0[4], c1[4], n0v[4], n1v[4];
    auto fetch = [&](uint4 (&f0)[4], uint4 (&f1)[4], int kb) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = kb + 64 * u + 16 * t;
        const bool ok = k < kend;
        f0[u] = (ok && v0) ? ld_stream(p0 + kb + 64 * u) : make_uint4(0, 0, 0, 0);
        f1[u] = (ok && v1) ? ld_stream(p1 + kb + 64 * u) : make_uint4(0, 0, 0, 0);
      }
    };
    fetch(c0, c1, kbeg);          // in flight while the activation is staged
    stage_activation(act, stride, a, a_sm, a_sk, M, kbeg, kend, a_mode, tid, NTHR);
    __syncthreads();
    for (int kb = kbeg; kb < kend; kb += dec::BATCH) {
      fetch(n0v, n1v, kb + dec::BATCH);
#pragma unroll
      for (int u = 0; u < 4; ++u) step64<NT>(acc, c0[u], c1[u], act_g + (kb - kbeg) + 64 * u, stride);
#pragma unroll
      for (int u = 0; u < 4; ++u) c0[u] = n0v[u], c1[u] = n1v[u];
    }
  } else {
    // [K, N] weights (b_sn == 1): thread (warp, lane) loads the 4 k-rows
    // kb + 4 (lane / 8 + 4 warp).. of the 16 columns n0 + 16 (lane % 8)..,
    // so eight lanes read a 128-byte run of one k-row; the transposed
    // words go to tile row n, 16-byte chunk (k / 16) ^ (n / 16) (the
    // swizzle keeps both these stores and the fragment reads
    // conflict-free)
    int8_t* tile = smem + dec::MROWS * stride;
    const int cg = lane & 7, kq = (lane >> 3) + 4 * warp;
    uint4 va[4], vb[4];
    auto fetch = [&](uint4 (&v)[4], int kb) {
      load_4x16(v, b, b_sn, b_sk, n0 + 16 * cg, N, kb + 4 * kq, kend, b_vec);
    };
    fetch(va, kbeg);              // two batches in flight while staging
    fetch(vb, kbeg + dec::KK_BATCH);
    stage_activation(act, stride, a, a_sm, a_sk, M, kbeg, kend, a_mode, tid, NTHR);
    int buf = 0;
    auto batch = [&](uint4 (&v)[4], int kb) {
      int8_t* tb = tile + buf * ROWS * dec::KK_STRIDE;
      uint32_t o[16];
      transpose_4x16(v, o);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int n = 16 * cg + i;
        *reinterpret_cast<uint32_t*>(tb + n * dec::KK_STRIDE + (((kq >> 2) ^ cg) << 4) +
                                     4 * (kq & 3)) = o[i];
      }
      __syncthreads();
      fetch(v, kb + 2 * dec::KK_BATCH);
      const int8_t* w0p = tb + (16 * warp + g) * dec::KK_STRIDE;
      const int sw = warp & 7;    // (16 warp + g) / 16
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int ch = ((4 * u + t) ^ sw) << 4;
        step64<NT>(acc, *reinterpret_cast<const uint4*>(w0p + ch),
                   *reinterpret_cast<const uint4*>(w0p + 8 * dec::KK_STRIDE + ch),
                   act_g + (kb - kbeg) + 64 * u, stride);
      }
      buf ^= 1;
    };
    for (int kb = kbeg; kb < kend; kb += 2 * dec::KK_BATCH) {
      batch(va, kb);
      if (kb + dec::KK_BATCH < kend) batch(vb, kb + dec::KK_BATCH);
    }
  }

  // the int32 partial sums: part[split][n][16 tokens]
  const int np = gridDim.x * ROWS;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + warp * 16 + g + 8 * h;
      *reinterpret_cast<int2*>(part + ((long long)split * np + n) * 16 + 8 * j + 2 * t) =
          make_int2(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  __threadfence();
  __syncthreads();
  __shared__ int last;
  if (tid == 0) last = atomicAdd(&counters[blockIdx.x], 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < ROWS * M; i += NTHR) {
    const int m = i / ROWS, n = n0 + i % ROWS;
    if (n < N) {
      int s = 0;
#pragma unroll 16  // the splits' loads in flight together
      for (int sp = 0; sp < splits; ++sp) s += __ldcg(part + ((long long)sp * np + n) * 16 + m);
      put(c, out_f32, (long long)m * N + n, rank1(s, __fmul_rn(sa[m], alpha), sb[n]));
    }
  }
  if (tid == 0) counters[blockIdx.x] = 0;  // ready for the next launch (and graph replay)
}

// ---------------------------------------------------------------------------
// prefill: M > 16, wgmma from a 128-byte-swizzled ring
// ---------------------------------------------------------------------------

namespace pre {
constexpr int THREADS = 256;      // two warpgroups, 64 rows of the tile each
constexpr int BM = 128, BK = 128;
// the ring for `raws` K-major operands: swizzled stages, and the depth of
// the raw ring their tiles arrive in (what fits in 227 KB)
__host__ __device__ constexpr int stages(int bn, int raws) {
  return raws == 2 ? 3 : (raws == 1 || bn == 128 ? 5 : 4);
}
__host__ __device__ constexpr int raw_depth(int raws) { return raws == 2 ? 4 : 3; }
__host__ __device__ constexpr size_t smem(int bn, bool a_raw, bool b_raw) {
  const int raws = a_raw + b_raw;
  return (size_t)stages(bn, raws) * (BM + bn) * BK +
         (raws ? (size_t)raw_depth(raws) * ((a_raw ? BM : 0) + (b_raw ? bn : 0)) * BK : 0) +
         1024;   // + slack to align to 1024
}
}  // namespace pre

__device__ __forceinline__ void cp_async16(int8_t* dst, const int8_t* src, int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += a' b'^T over 32 bytes of K, d the warpgroup's 64 x n sums
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
      "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, "
      "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, "
      "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]),
        "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]),
        "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]),
        "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]),
        "+r"(d[119]), "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// o[s] <- o[(s + r) & 15] for r in 0..7 (three conditional rotations, all
// register indices fixed)
__device__ __forceinline__ void rotate16(uint32_t (&o)[16], int r) {
#pragma unroll
  for (int b = 1; b < 8; b <<= 1) {
    uint32_t t[16];
#pragma unroll
    for (int s = 0; s < 16; ++s) t[s] = (r & b) ? o[(s + b) & 15] : o[s];
#pragma unroll
    for (int s = 0; s < 16; ++s) o[s] = t[s];
  }
}

// One operand's tile: ROWS rows from r0 and 128 bytes of K from k0.
// K-contiguous (KMAJOR false): `copy` issues 16-byte cp.async into the
// swizzled stage, zero-filled beyond R and K.  K-major: `copy_raw` brings
// the tile as it lies, [128 k-rows][ROWS bytes], into a raw slot (16-byte
// cp.async, or byte copies when the rows are not 16-byte aligned), and
// `land` transposes it into the swizzled stage: thread (g = tid % 8, kq)
// reads 4 k-rows x 16 rows (eight lanes a 128-byte k-row), transposes the
// 4x4 byte blocks, and stores row 16 g + (s + g) % 16 at step s, so that
// the eight lane groups hit eight swizzled chunks (the words rotated in
// registers to match).  Register loads are not kept in flight across the
// ring's proxy fences, which would drain them every stage.
template <bool KMAJOR, int ROWS>
struct Operand {
  const int8_t* p;
  long long s_r, s_k;
  int R, K;
  bool vec;

  __device__ __forceinline__ void copy(int8_t* dst, int r0, int k0, int tid) const {
#pragma unroll
    for (int i = 0; i < ROWS * pre::BK / 16 / pre::THREADS; ++i) {
      const int id = tid + i * pre::THREADS, row = id >> 3, ch = id & 7;
      const int r = r0 + row, k = k0 + 16 * ch;
      const bool ok = r < R && k < K;
      cp_async16(dst + swz(row, ch), ok ? p + (long long)r * s_r + k : p, ok ? 16 : 0);
    }
  }
  __device__ __forceinline__ void copy_raw(int8_t* raw, int r0, int k0, int tid) const {
    if (vec) {
      constexpr int CPR = ROWS / 16;        // 16-byte chunks a k-row
#pragma unroll
      for (int i = 0; i < ROWS * pre::BK / 16 / pre::THREADS; ++i) {
        const int id = tid + i * pre::THREADS, kr = id / CPR, cc = id % CPR;
        const int k = k0 + kr, r = r0 + 16 * cc;
        const bool ok = k < K && r < R;
        cp_async16(raw + kr * ROWS + 16 * cc, ok ? p + (long long)k * s_k + r : p, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < ROWS * pre::BK; i += pre::THREADS) {
        const int k = k0 + i / ROWS, r = r0 + i % ROWS;
        raw[i] = (k < K && r < R) ? p[(long long)r * s_r + (long long)k * s_k] : (int8_t)0;
      }
    }
  }
  __device__ __forceinline__ void land(int8_t* dst, const int8_t* raw, int tid) const {
    const int g = tid & 7, kq = ((tid & 31) >> 3) + 4 * (tid >> 5);
#pragma unroll
    for (int u = 0; u < ROWS / 128; ++u) {
      uint4 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = *reinterpret_cast<const uint4*>(raw + (4 * kq + j) * ROWS + 128 * u + 16 * g);
      uint32_t o[16];
      transpose_4x16(v, o);
      rotate16(o, g);
#pragma unroll
      for (int s = 0; s < 16; ++s) {
        const int row = 128 * u + 16 * g + ((s + g) & 15);
        *reinterpret_cast<uint32_t*>(dst + swz(row, kq >> 2) + 4 * (kq & 3)) = o[s];
      }
    }
  }
};

template <bool A_KMAJOR, bool B_KMAJOR, int BN>
__global__ void __launch_bounds__(pre::THREADS, 1)
gemm_prefill(const int8_t* __restrict__ a, long long a_sm, long long a_sk, int a_vec,
             const int8_t* __restrict__ b, long long b_sn, long long b_sk, int b_vec,
             const float* __restrict__ sa, const float* __restrict__ sb, float alpha,
             void* __restrict__ c, int out_f32, int M, int N, int K) {
  // S swizzled stages; K-contiguous tiles arrive DS = S - 2 tiles ahead
  // straight into their stage, K-major ones DR tiles ahead into a raw slot
  // and land (transposed) one tile ahead.  W: cp.async groups that may
  // still be in flight at the top of an iteration; P: prologue groups.
  constexpr int RAWS = A_KMAJOR + B_KMAJOR, S = pre::stages(BN, RAWS), DS = S - 2;
  constexpr int DR = pre::raw_depth(RAWS);
  constexpr int W = RAWS == 0 ? DS - 1 : RAWS == 2 ? DR - 2 : (DR - 2 < DS - 1 ? DR - 2 : DS - 1);
  constexpr int P = RAWS == 0 ? DS : RAWS == 2 ? DR : (DR > DS ? DR : DS);
  constexpr int STAGE = (pre::BM + BN) * pre::BK;
  constexpr int A_RAW = A_KMAJOR ? pre::BM * pre::BK : 0, RAW = A_RAW + (B_KMAJOR ? BN * pre::BK : 0);
  extern __shared__ __align__(16) int8_t smem_raw[];
  int8_t* smem = reinterpret_cast<int8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.y * pre::BM, n0 = blockIdx.x * BN;
  const int kt_n = (K + pre::BK - 1) / pre::BK;
  auto a_st = [&](int s) { return smem + s * STAGE; };
  auto b_st = [&](int s) { return smem + s * STAGE + pre::BM * pre::BK; };
  auto a_raw = [&](int t) { return smem + S * STAGE + (t % DR) * RAW; };
  auto b_raw = [&](int t) { return smem + S * STAGE + (t % DR) * RAW + A_RAW; };

  const Operand<A_KMAJOR, pre::BM> A{a, A_KMAJOR ? 1 : a_sm, A_KMAJOR ? a_sk : 1, M, K, a_vec != 0};
  const Operand<B_KMAJOR, BN> B{b, B_KMAJOR ? 1 : b_sn, B_KMAJOR ? b_sk : 1, N, K, b_vec != 0};

  // the loads of iteration i (the prologue's are i = -P..-1), one group
  auto issue = [&](int i) {
    if constexpr (A_KMAJOR) {
      if (i + DR >= 0 && i + DR < kt_n) A.copy_raw(a_raw(i + DR), m0, (i + DR) * pre::BK, tid);
    } else if (i + DS >= 0 && i + DS < kt_n) {
      A.copy(a_st((i + DS) % S), m0, (i + DS) * pre::BK, tid);
    }
    if constexpr (B_KMAJOR) {
      if (i + DR >= 0 && i + DR < kt_n) B.copy_raw(b_raw(i + DR), n0, (i + DR) * pre::BK, tid);
    } else if (i + DS >= 0 && i + DS < kt_n) {
      B.copy(b_st((i + DS) % S), n0, (i + DS) * pre::BK, tid);
    }
    asm volatile("cp.async.commit_group;\n");
  };
  for (int i = -P; i < 0; ++i) issue(i);
  if constexpr (RAWS > 0) {          // K-major tile 0 lands before the loop
    cp_async_wait<DR - 1>();
    __syncthreads();
    if constexpr (A_KMAJOR) A.land(a_st(0), a_raw(0), tid);
    if constexpr (B_KMAJOR) B.land(b_st(0), b_raw(0), tid);
  }

  int d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0;

  // iteration kt: tile kt is in stage kt % S; K-major tile kt + 1 lands in
  // stage (kt + 1) % S; the loads of iteration kt refill stage (kt + DS) %
  // S and raw slot kt % DR.  Those held tiles <= kt - 2 (stages; wgmma
  // waited for by every warpgroup before this iteration's barrier) and
  // tile kt (the raw slot, landed during iteration kt - 1).
  for (int kt = 0; kt < kt_n; ++kt) {
    const int st = kt % S;
    cp_async_wait<W>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    const uint64_t da = wgmma_desc(a_st(st) + wg * 64 * 128), db = wgmma_desc(b_st(st));
#pragma unroll
    for (int j = 0; j < pre::BK / 32; ++j) wgmma_s8(d, da + 2 * j, db + 2 * j);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (kt + 1 < kt_n) {
      if constexpr (A_KMAJOR) A.land(a_st((kt + 1) % S), a_raw(kt + 1), tid);
      if constexpr (B_KMAJOR) B.land(b_st((kt + 1) % S), b_raw(kt + 1), tid);
    }
    issue(kt);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

  // d[4i + e]: row 16 warp + lane / 4 (+ 8 for e >= 2) of the warpgroup's
  // 64, column 8 i + 2 (lane % 4) (+ 1 for odd e)
  const int lane = tid & 31, wrow = m0 + wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const bool pair = (N & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = wrow + 8 * h;
    if (m >= M) continue;
    const float sam = __fmul_rn(sa[m], alpha);
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int n = n0 + 8 * i + 2 * (lane & 3);
      const long long o = (long long)m * N + n;
      if (n + 1 < N)
        put2(c, out_f32, o, rank1(d[4 * i + 2 * h], sam, sb[n]),
             rank1(d[4 * i + 2 * h + 1], sam, sb[n + 1]), pair);
      else if (n < N)
        put(c, out_f32, o, rank1(d[4 * i + 2 * h], sam, sb[n]));
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

// K-contiguous and fit for 16-byte loads: the rows' stride, K and the base
bool k_contiguous(const void* p, long long s_r, long long s_k, int K) {
  return s_k == 1 && s_r % 16 == 0 && K % 16 == 0 && aligned(p, 16);
}

template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes, bool (&done)[kMaxDev]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDev && done[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < kMaxDev) done[dev] = true;
  return err;
}

int sm_count() {
  static int n[kMaxDev] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDev) return 132;
  if (n[dev] == 0 && cudaDeviceGetAttribute(&n[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    n[dev] = 132;
  return n[dev];
}

template <bool BK, int NT>
int launch_decode(const int8_t* a, long long a_sm, long long a_sk, int a_mode, const int8_t* b,
                  long long b_sn, long long b_sk, int b_vec, const float* sa, const float* sb,
                  float alpha, void* c, int out_f32, int M, int N, int K, int kc, int* part,
                  int* counters, cudaStream_t stream) {
  static bool done[kMaxDev] = {};
  const cudaError_t err = allow_smem(gemm_decode<BK, NT>, dec::smem(dec::MAX_KC, BK), done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + dec::rows(BK) - 1) / dec::rows(BK), (K + kc - 1) / kc);
  gemm_decode<BK, NT><<<grid, dec::threads(BK), dec::smem(kc, BK), stream>>>(
      a, a_sm, a_sk, a_mode, b, b_sn, b_sk, b_vec, sa, sb, alpha, c, out_f32, M, N, K, kc, part,
      counters);
  return (int)cudaGetLastError();
}

template <bool AK, bool BK, int BN>
int launch_prefill(const int8_t* a, long long a_sm, long long a_sk, int a_vec, const int8_t* b,
                   long long b_sn, long long b_sk, int b_vec, const float* sa, const float* sb,
                   float alpha, void* c, int out_f32, int M, int N, int K, cudaStream_t stream) {
  static bool done[kMaxDev] = {};
  const cudaError_t err = allow_smem(gemm_prefill<AK, BK, BN>, pre::smem(BN, AK, BK), done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BN - 1) / BN, (M + pre::BM - 1) / pre::BM);
  gemm_prefill<AK, BK, BN><<<grid, pre::THREADS, pre::smem(BN, AK, BK), stream>>>(
      a, a_sm, a_sk, a_vec, b, b_sn, b_sk, b_vec, sa, sb, alpha, c, out_f32, M, N, K);
  return (int)cudaGetLastError();
}

// 128 x 256 tiles read 25% fewer operand bytes per MAC than 128 x 128, and
// win wherever they still give the card a full wave; with a K-major
// operand the raw ring leaves room for 128 only
template <bool AK, bool BK>
int launch_prefill_tile(const int8_t* a, long long a_sm, long long a_sk, int a_vec, const int8_t* b,
                        long long b_sn, long long b_sk, int b_vec, const float* sa, const float* sb,
                        float alpha, void* c, int out_f32, int M, int N, int K, cudaStream_t st) {
  if constexpr (!AK && !BK) {
    if ((long long)((M + pre::BM - 1) / pre::BM) * ((N + 255) / 256) >= sm_count())
      return launch_prefill<AK, BK, 256>(a, a_sm, a_sk, a_vec, b, b_sn, b_sk, b_vec, sa, sb, alpha, c,
                                         out_f32, M, N, K, st);
  }
  return launch_prefill<AK, BK, 128>(a, a_sm, a_sk, a_vec, b, b_sn, b_sk, b_vec, sa, sb, alpha, c,
                                     out_f32, M, N, K, st);
}

}  // namespace

// a'[m, k] = a[m * a_sm + k * a_sk], b'[n, k] = b[n * b_sn + k * b_sk]; sa
// [M], sb [N] fp32; c [M, N] bf16 or (out_f32) fp32.  M <= 16 runs the
// decode kernel with K split into slices of kc (a multiple of 256 for
// K-contiguous b', of 128 for K-major b'; at most 2048) and needs part,
// int32 [ceil(K / kc), R ceil(N / R), 16] with R = 64 (K-contiguous b') or
// 128 (K-major b'), and counters, int32 [ceil(N / R)] all zero (the kernel
// leaves them zero).  A layout that neither kernel takes returns
// cudaErrorInvalidValue.
extern "C" int qt_gemm_int8_rank1(const void* a, long long a_sm, long long a_sk, const void* b,
                                  long long b_sn, long long b_sk, const void* sa, const void* sb,
                                  float alpha, void* c, int out_f32, int M, int N, int K,
                                  void* part, void* counters, int kc, void* stream) {
  const int8_t *ap = (const int8_t*)a, *bp = (const int8_t*)b;
  const float *sap = (const float*)sa, *sbp = (const float*)sb;
  const cudaStream_t st = (cudaStream_t)stream;
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const bool b_nk = k_contiguous(b, b_sn, b_sk, K);
  const bool b_kmaj = !b_nk && b_sn == 1;
  if (!b_nk && !b_kmaj) return (int)cudaErrorInvalidValue;
  const int b_vec = b_kmaj && b_sk % 16 == 0 && N % 16 == 0 && aligned(b, 16);
  if (M <= 16) {
    const int gran = b_kmaj ? dec::KK_BATCH : dec::BATCH;
    if (part == nullptr || counters == nullptr || kc <= 0 || kc % gran || kc > dec::MAX_KC)
      return (int)cudaErrorInvalidValue;
    const int a_mode = k_contiguous(a, a_sm, a_sk, K) ? 1
                       : (a_sm == 1 && M % 4 == 0 && a_sk % 4 == 0 && K % 4 == 0 && aligned(a, 4)) ? 2
                                                                                                 : 0;
    int* pp = (int*)part;
    int* cp = (int*)counters;
    if (b_kmaj)
      return M <= 8 ? launch_decode<true, 1>(ap, a_sm, a_sk, a_mode, bp, b_sn, b_sk, b_vec, sap, sbp,
                                            alpha, c, out_f32, M, N, K, kc, pp, cp, st)
                    : launch_decode<true, 2>(ap, a_sm, a_sk, a_mode, bp, b_sn, b_sk, b_vec, sap, sbp,
                                            alpha, c, out_f32, M, N, K, kc, pp, cp, st);
    return M <= 8 ? launch_decode<false, 1>(ap, a_sm, a_sk, a_mode, bp, b_sn, b_sk, 0, sap, sbp,
                                           alpha, c, out_f32, M, N, K, kc, pp, cp, st)
                  : launch_decode<false, 2>(ap, a_sm, a_sk, a_mode, bp, b_sn, b_sk, 0, sap, sbp,
                                           alpha, c, out_f32, M, N, K, kc, pp, cp, st);
  }
  const bool a_mk = k_contiguous(a, a_sm, a_sk, K);
  const bool a_kmaj = !a_mk && a_sm == 1;
  if (!a_mk && !a_kmaj) return (int)cudaErrorInvalidValue;
  const int a_vec = a_kmaj && a_sk % 16 == 0 && M % 16 == 0 && aligned(a, 16);
  if (a_kmaj)
    return b_kmaj ? launch_prefill_tile<true, true>(ap, a_sm, a_sk, a_vec, bp, b_sn, b_sk, b_vec, sap,
                                                    sbp, alpha, c, out_f32, M, N, K, st)
                  : launch_prefill_tile<true, false>(ap, a_sm, a_sk, a_vec, bp, b_sn, b_sk, 0, sap,
                                                     sbp, alpha, c, out_f32, M, N, K, st);
  return b_kmaj ? launch_prefill_tile<false, true>(ap, a_sm, a_sk, 0, bp, b_sn, b_sk, b_vec, sap, sbp,
                                                   alpha, c, out_f32, M, N, K, st)
                : launch_prefill_tile<false, false>(ap, a_sm, a_sk, 0, bp, b_sn, b_sk, 0, sap, sbp,
                                                    alpha, c, out_f32, M, N, K, st);
}
