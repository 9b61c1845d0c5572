// K4's warp-specialised prefill kernel for Hopper (gemm_fp4_mx.cu): the
// MXFP4 GEMM with both operands packed K-major (activation [K/2, M] and
// scales [K/32, M], weight [K/2, N] and [K/32, N], unit stride along the
// rows), above 16 rows:
//   C[m, n] = out( float(sum_g p_g sa_g sb_g) * alpha ),
// bitwise gemm_fp4_prefill<dec::Mx> (gemm_fp4_prefill.cuh) on every input:
// each 32-group's s = 4 p is exact in int32, and each output folds
// fma(fma(MAGIC + s, sa / 4, -MAGIC sa / 4), sb, acc) (pre::fold) in
// ascending k, so the fp64 sums round where and as they do there.
//
// Bound by the fp64 fold, two DFMA an output and group (33.5 TFLOP/s on
// the H100's CUDA cores: 0.096 ms at (M, K, N) = (512, 4096, 12288)), not
// by the int8 products (0.026 ms at the int8 peak).  The kernel is built so
// that the fp64 pipe sets the pace: the products run on the tensor cores
// asynchronously and the operand staging runs in warps of its own, so that
// neither takes the fold's issue slots beyond their share.
//
// A block of 384 threads owns 128 x BN outputs (BN = 128, 64 or 32, the
// largest whose grid fills the card, see pwg::pick_bn):
//  * two consumer warpgroups, 64 rows each.  Each 32-group of a 64 x WN
//    half tile (WN = min(BN, 64)) is one wgmma.mma_async m64nWNk32 s8 x s8
//    -> s32 with scale-d off: a fresh int32 accumulator holding the group's
//    s exactly, never a k that mixes two groups' scales.  Below BN = 128 two
//    accumulator sets alternate, so that the next group's wgmma runs while
//    the CUDA cores fold the last one into the thread's fp64 sums (BN / 2 a
//    thread, kept in registers: setmaxnreg gives the consumers what the
//    producers do not need); at BN = 128 two sets do not fit, and each
//    group's fold waits for its wgmma (SETS);
//  * one producer warpgroup.  It brings each 32-group's packed k-rows (16
//    of a, 16 of b: the 16-byte aligned run of up to 144 bytes that holds
//    the tile's bytes of a k-row) and its two scale rows into one of RD raw
//    slots in shared memory by 16-byte cp.async copies spread over its
//    threads, each thread's completing on the slot's mbarrier, RD groups
//    ahead.  All four warps then decode the
//    codes to int8 m2 (the doubled values, integers in [-12, 12];
//    dec::m2x4) and write them K-contiguous into the 128-byte swizzled
//    stage layout that 8-bit wgmma reads (a stage: 128 k, four groups),
//    beside the stage's scale rows as fp64 ({sa / 4, -MAGIC sa / 4} for
//    a's rows, sb for b's, from tables of the 256 bytes).  A ring of
//    STAGES stages, full / empty mbarriers between the two roles.
//
// A decoding thread's unit is 4 rows x 8 packed k-rows (16 k): eight words
// of the raw slot, and for each row the byte gather of two k-rows
// (__byte_perm) into four codes, decoded to four m2 bytes, four words a
// 16-byte store; the lanes write their rows in a rotated order so that each
// quarter warp's stores hit eight distinct swizzled chunks.  A K-major
// operand of any base and k-row stride is copied as its aligned runs, and
// where the base or the stride is not a multiple of 4 a funnel shift of two
// aligned words of the run puts a unit's 4 bytes in place.  A 16-byte
// aligned run that holds a valid byte lies in one page, so copying it
// cannot fault; its bytes beyond the operand's rows land in rows that the
// epilogue does not store.  So ragged M and column slices of a larger
// activation (an expert's rows) take the same path; there is no per-byte
// path.
//
// On the H100 it is slower than gemm_fp4_prefill<dec::Mx> at every shape
// measured (PERF.md §6: a fixed ~1.2 us a group a block on the H100), so no call
// of the port runs it (gemm_fp4_mx_wg.cu).
//
// No split-K, no workspace, no counters: graph-safe by construction.
// alpha is read from device memory, or taken by value where alpha_ptr is
// null.  bf16 or fp32 out.
#pragma once

#include "gemm_fp4_decode.cuh"
#include "gemm_fp4_prefill.cuh"
#include "wgmma_s8.cuh"

namespace {
namespace pwg {

constexpr int BM = 128;                        // rows a block: two consumer warpgroups
constexpr int BK = 128;                        // k a stage: 128 bytes of m2 a row
constexpr int GPS = BK / 32;                   // 32-groups a stage
constexpr int STAGES = 4;                      // the ring of m2 stages
constexpr int RD = 6;                          // raw slots: groups whose copies are in flight
constexpr int SETS = 1;                        // consumer accumulator sets at BN = 128
constexpr int WN_MAX = 64;                     // columns of a consumer's wgmma
constexpr int CONSUMERS = 256, PRODUCERS = 128, THREADS = CONSUMERS + PRODUCERS;
// registers a thread after setmaxnreg: 256 CONS_REGS + 128 PROD_REGS stays
// within the 384 x 168 the block is launched with
constexpr int CONS_REGS = 224, PROD_REGS = 56;
static_assert(CONSUMERS * CONS_REGS + PRODUCERS * PROD_REGS <= THREADS * 168, "register budget");
// a raw slot: one group's packed k-rows as they lie in device memory, 16 of
// a and 16 of b, each the 16-byte aligned run of up to 144 bytes that holds
// the tile's row bytes, in rows of RAW_ROW bytes (k-row r of an operand at
// row 2 (r % 8) + r / 8, so that the two k-rows a warp reads at once are
// half a bank cycle apart), then a's and b's scale rows the same way
constexpr int RAW_ROW = 192, RAW_SCALES = 32 * RAW_ROW, RAW_SLOT = RAW_SCALES + 2 * 160;

__host__ __device__ constexpr int wn(int bn) { return bn < WN_MAX ? bn : WN_MAX; }
// accumulator sets: two where the registers hold them beside the fp64 sums
__host__ __device__ constexpr int sets(int bn) { return bn == 128 ? SETS : 2; }

// one stage: a's m2 [BM][128 B] and b's [BN][128 B] (swizzled), a's scale
// pairs double2 [GPS][BM], b's scales double [GPS][BN]
template <int BN>
struct Stage {
  static constexpr int A = 0, B = BM * BK, SA = B + BN * BK, SB = SA + GPS * BM * 16;
  static constexpr int BYTES = SB + GPS * BN * 8;
  static_assert(BYTES % 1024 == 0 && B % 1024 == 0, "stage tiles 1024-aligned");
};

// dynamic shared memory: the ring, the raw slots, the scale tables, the
// barriers, and slack to align the ring to 1024
template <int BN>
__host__ __device__ constexpr size_t smem() {
  return 1024 + (size_t)STAGES * Stage<BN>::BYTES + (size_t)RD * RAW_SLOT + 256 * 16 + 256 * 8 +
         (2 * STAGES + RD) * 8;
}

__device__ __forceinline__ uint32_t sptr(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(sptr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(sptr(bar))
               : "memory");
}
// 16 bytes from 16-byte aligned src to 16-byte aligned dst
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sptr(dst)), "l"(src) : "memory");
}
// bar's phase waits for the thread's cp.async copies issued so far (one of
// its expected arrivals)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(sptr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(sptr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// the group's products of a 64 x WN half tile, from a zero accumulator
__device__ __forceinline__ void mma(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(0));
}
__device__ __forceinline__ void mma(int (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(0));
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// a half tile's group folded into its fp64 sums: d[4i + e] is row g + 8 (e
// / 2), column 8 i + 2 t + e % 2 of the warp's 16 x WN, sa0 / sa1 the scale
// pairs of rows g and g + 8, sb the half's scale row
template <int WN>
__device__ __forceinline__ void fold_half(double (&acc)[WN / 8][4], const int (&d)[WN / 2],
                                          double2 sa0, double2 sa1, const double* sb, int t) {
#pragma unroll
  for (int i = 0; i < WN / 8; ++i) {
    const double2 b = *reinterpret_cast<const double2*>(sb + 8 * i + 2 * t);
    acc[i][0] = pre::fold(d[4 * i + 0], sa0, b.x, acc[i][0]);
    acc[i][1] = pre::fold(d[4 * i + 1], sa0, b.y, acc[i][1]);
    acc[i][2] = pre::fold(d[4 * i + 2], sa1, b.x, acc[i][2]);
    acc[i][3] = pre::fold(d[4 * i + 3], sa1, b.y, acc[i][3]);
  }
}

// the 16-byte aligned run of device memory that holds `valid` bytes from p,
// as 16-byte copies take it: (start, bytes)
__device__ __forceinline__ uint32_t run_bytes(const uint8_t* p, int valid) {
  return ((uint32_t)(reinterpret_cast<uintptr_t>(p) & 15) + valid + 15) & ~15u;
}
__device__ __forceinline__ const uint8_t* run_start(const uint8_t* p) {
  return reinterpret_cast<const uint8_t*>(reinterpret_cast<uintptr_t>(p) & ~uintptr_t(15));
}

}  // namespace pwg

template <int BN, typename Out>
__global__ void __launch_bounds__(pwg::THREADS, 1)
gemm_fp4_prefill_wg(const uint8_t* __restrict__ a, long long a_k, const uint8_t* __restrict__ as,
                    long long as_m, long long as_g, const uint8_t* __restrict__ b, long long b_k,
                    const uint8_t* __restrict__ bs, long long bs_n, long long bs_g,
                    const float* __restrict__ alpha_ptr, float alpha_val, Out* __restrict__ c,
                    int M, int N, int K, int a_fun, int b_fun) {
  using namespace pwg;
  using St = Stage<BN>;
  constexpr int WN = wn(BN), H = BN / WN, NS = sets(BN);  // wgmma columns, half tiles, sets
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  uint8_t* raws = ring + STAGES * St::BYTES;
  double2* tab_a = reinterpret_cast<double2*>(raws + RD * RAW_SLOT);  // {v / 4, -MAGIC v / 4}
  double* tab_b = reinterpret_cast<double*>(tab_a + 256);              // v
  uint64_t* full = reinterpret_cast<uint64_t*>(tab_b + 256);
  uint64_t* empty = full + STAGES;
  uint64_t* landed = empty + STAGES;  // a raw slot's copies have landed
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int groups = K / 32, kt_n = (groups + GPS - 1) / GPS;
  const int va = min(BM, M - m0), vb = min(BN, N - n0);  // the tile's rows of a and of b
  for (int i = tid; i < 256; i += THREADS) {
    const double v = dec::Mx::scale(i);
    tab_a[i] = make_double2(0.25 * v, -dec::MAGIC * (0.25 * v));
    tab_b[i] = v;
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], PRODUCERS);
      mbar_init(&empty[s], CONSUMERS);
    }
    for (int s = 0; s < RD; ++s) mbar_init(&landed[s], PRODUCERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PROD_REGS));
    const int p = tid - CONSUMERS;
    // group g's 34 runs (k-rows 0..15 of a, of b, a's and b's scale row) into
    // raw slot g % RD, as 9 chunks of 16 bytes a run (those within it) spread
    // over the producer threads
    auto issue = [&](int g) {
      uint8_t* slot = raws + (g % RD) * RAW_SLOT;
      for (int c = p; c < 34 * 9; c += PRODUCERS) {
        const int run = c / 9, j = c - 9 * run, r = run & 15;
        const bool isa = run < 16 || run == 32;
        const uint8_t* src;
        uint8_t* dst;
        if (run < 32) {
          src = isa ? a + (long long)(16 * g + r) * a_k + m0 : b + (long long)(16 * g + r) * b_k + n0;
          dst = slot + (isa ? 0 : 16 * RAW_ROW) + (2 * (r & 7) + (r >> 3)) * RAW_ROW;
        } else {
          src = isa ? as + (long long)g * as_g + m0 : bs + (long long)g * bs_g + n0;
          dst = slot + RAW_SCALES + (isa ? 0 : 160);
        }
        if (16 * j < (int)run_bytes(src, isa ? va : vb)) cp_async16(dst + 16 * j, run_start(src) + 16 * j);
      }
      cp_async_arrive(&landed[g % RD]);
    };
    for (int g = 0; g < RD && g < groups; ++g) issue(g);

    // decoding: unit (q, hh) of a (p < 64) or of b, rows 4 q .. + 3 and 16 k
    // (packed k-rows 8 hh .. + 7 of the group)
    const bool is_a = p < BM / 2;
    const int u = is_a ? p : p - BM / 2, q = u >> 1, hh = u & 1;
    const bool unit = is_a ? 4 * q < va : (u < BN / 2 && 4 * q < vb);
    const uint8_t* base = is_a ? a + m0 : b + n0;
    const long long ld = is_a ? a_k : b_k;
    const bool fun = (is_a ? a_fun : b_fun) != 0;
    const int tile = is_a ? St::A : St::B;
    const int raw_op = is_a ? 0 : 16 * RAW_ROW;
    for (int kt = 0; kt < kt_n; ++kt) {
      const int slot = kt % STAGES;
      if (kt >= STAGES) mbar_wait(&empty[slot], ((kt / STAGES) - 1) & 1);
      uint8_t* st = ring + slot * St::BYTES;
      for (int kg = 0; kg < GPS; ++kg) {
        const int g = kt * GPS + kg;
        if (g >= groups) break;
        mbar_wait(&landed[g % RD], (g / RD) & 1);
        const uint8_t* raw = raws + (g % RD) * RAW_SLOT;
        if (unit) {
          // k-row i of the unit is raw row 2 i + hh; its first byte at the
          // offset of its run, o_i = address & 15
          const uint8_t* rows = raw + raw_op + hh * RAW_ROW;
          int o = (int)((reinterpret_cast<uintptr_t>(base) + (16 * g + 8 * hh) * ld) & 15);
          const int ld15 = (int)(ld & 15);
          uint32_t w[8];
          if (fun) {
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int at = o + 4 * q;
              const uint32_t* wp = reinterpret_cast<const uint32_t*>(rows + 2 * i * RAW_ROW + (at & ~3));
              w[i] = __funnelshift_r(wp[0], wp[1], 8 * (at & 3));
              o = (o + ld15) & 15;
            }
          } else {
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              w[i] = *reinterpret_cast<const uint32_t*>(rows + 2 * i * RAW_ROW + o + 4 * q);
              o = (o + ld15) & 15;
            }
          }
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int j = (v + q) & 3, sel = j | ((j + 4) << 4);
            uint4 x;
            x.x = dec::m2x4(__byte_perm(w[0], w[1], sel));
            x.y = dec::m2x4(__byte_perm(w[2], w[3], sel));
            x.z = dec::m2x4(__byte_perm(w[4], w[5], sel));
            x.w = dec::m2x4(__byte_perm(w[6], w[7], sel));
            *reinterpret_cast<uint4*>(st + tile + wgs8::swz(4 * q + j, 2 * kg + hh)) = x;
          }
        }
        // scale bytes: a's row m0 + p, b's column n0 + p
        const uint8_t* sraw = raw + RAW_SCALES;
        if (p < va) {
          const int o = (int)((reinterpret_cast<uintptr_t>(as) + (long long)g * as_g + m0) & 15);
          reinterpret_cast<double2*>(st + St::SA)[kg * BM + p] = tab_a[sraw[o + p]];
        }
        if (p < vb) {
          const int o = (int)((reinterpret_cast<uintptr_t>(bs) + (long long)g * bs_g + n0) & 15);
          reinterpret_cast<double*>(st + St::SB)[kg * BN + p] = tab_b[sraw[160 + o + p]];
        }
        // the slot is read: the first warp copies group g + RD into it
        asm volatile("bar.sync 1, %0;\n" ::"n"(PRODUCERS) : "memory");
        if (g + RD < groups) issue(g + RD);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&full[slot]);
    }
    return;
  }

  // consumers: warpgroup cw owns rows 64 cw .. + 63; thread (g, t) of warp
  // wi its rows rr and rr + 8, columns 8 i + 2 t (+ 1) of each half tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONS_REGS));
  const int cw = tid >> 7, wi = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rr = 64 * cw + 16 * wi + g;
  double acc[H][WN / 8][4];
  int d[NS][WN / 2];
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int i = 0; i < WN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][i][e] = 0.0;
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int i = 0; i < WN / 2; ++i) d[s][i] = 0;

  // the descriptors of group kg, half h of a stage
  auto da = [&](const uint8_t* st, int kg) {
    return wgs8::wgmma_desc(st + St::A + cw * 64 * BK) + 2 * kg;
  };
  auto db = [&](const uint8_t* st, int kg, int h) {
    return wgs8::wgmma_desc(st + St::B + h * WN * BK) + 2 * kg;
  };
  if constexpr (NS == 2) {
    mbar_wait(&full[0], 0);
    wg_fence();
    mma(d[0], da(ring, 0), db(ring, 0, 0));
    wg_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    const int slot = kt % STAGES;
    const uint8_t* st = ring + slot * St::BYTES;
    if constexpr (NS == 1) mbar_wait(&full[slot], (kt / STAGES) & 1);
#pragma unroll
    for (int kg = 0; kg < GPS; ++kg) {
      if (kt * GPS + kg < groups) {
        const double2* sap = reinterpret_cast<const double2*>(st + St::SA) + kg * BM + rr;
        const double2 sa0 = sap[0], sa1 = sap[8];
        const double* sb = reinterpret_cast<const double*>(st + St::SB) + kg * BN;
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const int j = kg * H + h;
          if constexpr (NS == 1) {
            wg_fence();
            mma(d[0], da(st, kg), db(st, kg, h));
            wg_commit();
            wg_wait<0>();
          } else {
            // the next step's wgmma, in flight while this one is folded
            const int nh = h + 1 < H ? h + 1 : 0, nkg = h + 1 < H ? kg : kg + 1;
            if (nkg < GPS) {
              if (kt * GPS + nkg < groups) {
                wg_fence();
                mma(d[(j + 1) % NS], da(st, nkg), db(st, nkg, nh));
                wg_commit();
                wg_wait<1>();
              } else {
                wg_wait<0>();
              }
            } else if (kt + 1 < kt_n) {
              const int ns = (kt + 1) % STAGES;
              const uint8_t* nst = ring + ns * St::BYTES;
              mbar_wait(&full[ns], ((kt + 1) / STAGES) & 1);
              wg_fence();
              mma(d[(j + 1) % NS], da(nst, 0), db(nst, 0, 0));
              wg_commit();
              wg_wait<1>();
            } else {
              wg_wait<0>();
            }
          }
          fold_half<WN>(acc[h], d[j % NS], sa0, sa1, sb + h * WN, t);
        }
      }
    }
    mbar_arrive(&empty[slot]);
  }

  const float alpha = alpha_ptr != nullptr ? *alpha_ptr : alpha_val;
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int i = 0; i < WN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + rr + 8 * (e >> 1), n = n0 + h * WN + 8 * i + 2 * t + (e & 1);
        if (m < M && n < N)
          qt::tile::out(c, (long long)m * N + n, __fmul_rn(__double2float_rn(acc[h][i][e]), alpha));
      }
}

namespace pwg {

// the block's columns: the BN of 128, 64, 32 that takes the fewest waves
// of one block an SM times a block's time, modelled as BN + 16 (the fold
// grows with BN, the staging of a's 128 rows does not)
inline int pick_bn(int M, int N, int sms) {
  const long long rows = (M + BM - 1) / BM;
  const int bns[3] = {128, 64, 32};
  int best = 128;
  long long best_cost = -1;
  for (int bn : bns) {
    const long long waves = (rows * ((N + bn - 1) / bn) + sms - 1) / sms;
    const long long cost = waves * (bn + 16);
    if (best_cost < 0 || cost < best_cost) best = bn, best_cost = cost;
  }
  return best;
}

template <int BN, typename Out>
int launch_bn(const uint8_t* a, long long a_k, const uint8_t* as, long long as_m, long long as_g,
              const uint8_t* b, long long b_k, const uint8_t* bs, long long bs_n, long long bs_g,
              const float* alpha, float alpha_val, Out* c, int M, int N, int K, int a_fun,
              int b_fun, int dev, cudaStream_t st) {
  static bool ready[pre::kMaxDev] = {};
  if (dev >= pre::kMaxDev || !ready[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_fp4_prefill_wg<BN, Out>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem<BN>());
    if (err != cudaSuccess) return (int)err;
    if (dev < pre::kMaxDev) ready[dev] = true;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_fp4_prefill_wg<BN, Out><<<grid, THREADS, smem<BN>(), st>>>(
      a, a_k, as, as_m, as_g, b, b_k, bs, bs_n, bs_g, alpha, alpha_val, c, M, N, K, a_fun, b_fun);
  return (int)cudaGetLastError();
}

// rows contiguous in aligned 4-byte words: no funnel
inline bool words(const void* q, long long ld) { return dec::aligned(q, 4) && ld % 4 == 0; }

// the kernel on packed K-major operands and scales of unit stride along
// their rows (a_m == b_n == as_m == bs_n == 1), any base and k-row stride;
// K % 32 == 0, and M within the grid's 65535 row tiles
template <typename Out>
int run(const uint8_t* a, long long a_m, long long a_k, const uint8_t* as, long long as_m,
        long long as_g, const uint8_t* b, long long b_n, long long b_k, const uint8_t* bs,
        long long bs_n, long long bs_g, const float* alpha, float alpha_val, Out* c, int M, int N,
        int K, cudaStream_t st) {
  if (a_m != 1 || b_n != 1 || as_m != 1 || bs_n != 1 || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  static int sms[pre::kMaxDev] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int n_sm = dev < pre::kMaxDev ? sms[dev] : 0;
  if (n_sm == 0) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < pre::kMaxDev) sms[dev] = n_sm;
  }
  const int af = !words(a, a_k), bf = !words(b, b_k);
  switch (pick_bn(M, N, n_sm)) {
    case 128:
      return launch_bn<128>(a, a_k, as, as_m, as_g, b, b_k, bs, bs_n, bs_g, alpha, alpha_val, c, M,
                            N, K, af, bf, dev, st);
    case 64:
      return launch_bn<64>(a, a_k, as, as_m, as_g, b, b_k, bs, bs_n, bs_g, alpha, alpha_val, c, M,
                           N, K, af, bf, dev, st);
    default:
      return launch_bn<32>(a, a_k, as, as_m, as_g, b, b_k, bs, bs_n, bs_g, alpha, alpha_val, c, M,
                           N, K, af, bf, dev, st);
  }
}

}  // namespace pwg
}  // namespace
