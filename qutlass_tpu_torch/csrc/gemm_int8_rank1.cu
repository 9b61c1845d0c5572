// K3 gemm_int8_rank1: the int8 evaluator's GEMM,
//   C[m, n] = bf16( float(sum_k a'[m, k] * b'[n, k]) * (sa[m] * alpha) * sb[n] ).
//
// Replaces the XLA int8 dot plus rank-1 epilogue of
// qutlass_tpu/ops/int8path.py:matmul_mxf4_bf16_int8{,_kmajor,_kk}
// (:133-180); the JAX package leaves it to XLA, the H100 needs it by hand:
// torch._int_mm refuses M <= 16, which is every decode step, and would
// leave the epilogue as a second pass over [M, N] in fp32.
//
// What bounds it on the H100: at decode (M = batch) the weight bytes
// (N*K int8, one byte per MAC); at prefill the int8 tensor-core rate.
// The accumulator is exact in int32 (|a'| <= 96, so |sum| <= 9216*K).
//
// Design: 64x64 output tiles, four warps of 32x32, each issuing
// mma.sync.m16n8k32 s8*s8->s32 from shared memory.  Operands are read
// through strides, so [K, M] activations and [N, K] or [K, N] weights
// share the kernel; 16-byte loads where the layout allows, and the next
// K tile's loads in flight while the current one is multiplied.  Shared
// tiles are stored [row][k] with a 16-byte pad, which makes every
// fragment load one conflict-free 32-bit read.  The
// epilogue multiplies in exactly the order of the JAX op, with
// round-to-nearest intrinsics, so the result is bitwise equal to it.
#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 64;
constexpr int THREADS = 128;
constexpr int SSTRIDE = BK + 16;

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Loads one [64 rows, BK] tile of a logical [R, K] int8 operand with
// strides (s_r, s_k) into registers, then stores it to t[row][k].  The
// next tile's loads start before the current tile's MMAs, so their
// latency hides behind the math.  VEC: 16-byte loads along the unit-stride
// axis (the host checks alignment and extents); otherwise one byte each.
template <bool VEC>
struct TileLoader {
  static constexpr int kVec = 64 * BK / 16 / THREADS;  // uint4 per thread
  static constexpr int kScalar = 64 * BK / THREADS;    // bytes per thread
  const int8_t* g;
  long long s_r, s_k;
  int R, K;
  bool r_fast;  // rows are the unit-stride axis
  uint4 v[VEC ? kVec : 1];
  int8_t b[VEC ? 1 : kScalar];

  __device__ __forceinline__ void load(int r0, int k0, int tid) {
    if constexpr (VEC) {
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        const int idx = tid + c * THREADS, major = idx >> 2, minor = (idx & 3) * 16;
        const int r = r0 + (r_fast ? minor : major), kg = k0 + (r_fast ? major : minor);
        v[c] = (r < R && kg < K)
                   ? *reinterpret_cast<const uint4*>(g + (long long)r * s_r + (long long)kg * s_k)
                   : make_uint4(0, 0, 0, 0);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kScalar; ++j) {
        const int idx = tid + j * THREADS;
        const int rr = r_fast ? idx % 64 : idx / BK, kk = r_fast ? idx / 64 : idx % BK;
        const int r = r0 + rr, kg = k0 + kk;
        b[j] = (r < R && kg < K) ? g[(long long)r * s_r + (long long)kg * s_k] : (int8_t)0;
      }
    }
  }

  __device__ __forceinline__ void store(int8_t (*t)[SSTRIDE], int tid) const {
    if constexpr (VEC) {
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        const int idx = tid + c * THREADS, major = idx >> 2, minor = (idx & 3) * 16;
        if (!r_fast) {
          *reinterpret_cast<uint4*>(&t[major][minor]) = v[c];
        } else {
          const int8_t* bytes = reinterpret_cast<const int8_t*>(&v[c]);
#pragma unroll
          for (int j = 0; j < 16; ++j) t[minor + j][major] = bytes[j];
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kScalar; ++j) {
        const int idx = tid + j * THREADS;
        t[r_fast ? idx % 64 : idx / BK][r_fast ? idx / 64 : idx % BK] = b[j];
      }
    }
  }
};

template <bool VEC_A, bool VEC_B>
__global__ void __launch_bounds__(THREADS)
gemm_int8_rank1_kernel(const int8_t* __restrict__ a, long long a_sm, long long a_sk,
                       const int8_t* __restrict__ b, long long b_sn, long long b_sk,
                       const float* __restrict__ sa, const float* __restrict__ sb, float alpha,
                       __nv_bfloat16* __restrict__ c, int M, int N, int K) {
  __shared__ __align__(16) int8_t As[BM][SSTRIDE];
  __shared__ __align__(16) int8_t Bs[BN][SSTRIDE];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  TileLoader<VEC_A> la{a, a_sm, a_sk, M, K, a_sm == 1};
  TileLoader<VEC_B> lb{b, b_sn, b_sk, N, K, b_sn == 1};
  la.load(m0, 0, tid);
  lb.load(n0, 0, tid);
  for (int k0 = 0; k0 < K; k0 += BK) {
    la.store(As, tid);
    lb.store(Bs, tid);
    __syncthreads();
    if (k0 + BK < K) {  // next tile in flight during this tile's MMAs
      la.load(m0, k0 + BK, tid);
      lb.load(n0, k0 + BK, tid);
    }
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + i * 16 + g;
        af[i][0] = *reinterpret_cast<const uint32_t*>(&As[r][ks + t * 4]);
        af[i][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][ks + t * 4]);
        af[i][2] = *reinterpret_cast<const uint32_t*>(&As[r][ks + 16 + t * 4]);
        af[i][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][ks + 16 + t * 4]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = wn + j * 8 + g;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(&Bs[r][ks + t * 4]);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(&Bs[r][ks + 16 + t * 4]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + i * 16 + g + (e >> 1) * 8;
        const int n = n0 + wn + j * 8 + t * 2 + (e & 1);
        if (m < M && n < N) {
          const float y = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][e]), __fmul_rn(sa[m], alpha)), sb[n]);
          c[(long long)m * N + n] = __float2bfloat16_rn(y);
        }
      }
}

// 16-byte loads need a 16-byte aligned base, a unit-stride axis whose
// extent is a multiple of 16, and the other stride a multiple of 16
bool vec_ok(const void* p, long long s_r, long long s_k, int R, int K) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  if (s_k == 1) return s_r % 16 == 0 && K % 16 == 0;
  if (s_r == 1) return s_k % 16 == 0 && R % 16 == 0;
  return false;
}

}  // namespace

extern "C" int qt_gemm_int8_rank1(const void* a, long long a_sm, long long a_sk, const void* b,
                                  long long b_sn, long long b_sk, const void* sa, const void* sb,
                                  float alpha, void* c, int M, int N, int K, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const bool va = vec_ok(a, a_sm, a_sk, M, K), vb = vec_ok(b, b_sn, b_sk, N, K);
  auto kernel = va ? (vb ? gemm_int8_rank1_kernel<true, true> : gemm_int8_rank1_kernel<true, false>)
                   : (vb ? gemm_int8_rank1_kernel<false, true> : gemm_int8_rank1_kernel<false, false>);
  kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)a, a_sm, a_sk, (const int8_t*)b, b_sn, b_sk, (const float*)sa,
      (const float*)sb, alpha, (__nv_bfloat16*)c, M, N, K);
  return (int)cudaGetLastError();
}
