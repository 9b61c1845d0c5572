// Helpers of the int8 wgmma kernels, shared by K3's prefill kernel
// (gemm_int8_rank1.cu) and K4's warp-specialised MXFP4 prefill kernel
// (gemm_fp4_prefill_wg.cuh): the 128-byte swizzle of a K-major stage
// tile, its wgmma descriptor, and the 4x4 byte transpose.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace wgs8 {

// byte offset of 16-byte chunk `ch` of row `r` in a [rows][128 B] tile with
// the 128-byte swizzle wgmma's descriptor names (the tile 1024-aligned)
__device__ __forceinline__ int swz(int r, int ch) { return r * 128 + ((ch ^ (r & 7)) << 4); }

// a K-major operand descriptor: start >> 4, leading offset 1 (unused with
// the swizzle), 1024 bytes between 8-row groups, 128-byte swizzle
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((s & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// rows r0..r3 of a 4x4 byte block -> its columns: o[i] byte j = r_j byte i
__device__ __forceinline__ void transpose4x4(uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3,
                                             uint32_t* o) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r0, r1, 0x7362);
  const uint32_t t2 = __byte_perm(r2, r3, 0x5140), t3 = __byte_perm(r2, r3, 0x7362);
  o[0] = __byte_perm(t0, t2, 0x5410);
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

}  // namespace wgs8
}  // namespace
