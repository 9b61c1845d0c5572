// K5 quantize_nv: fused rotation + NVFP4 quantization (group 16, e4m3
// scale bytes, abs-max scales through a global scale).
//
// Replaces the Pallas kernel qutlass_tpu/kernels/quantize.py:
// fused_quantize_nv (body _quantize_nv_kernel, :117-135).  On the serving
// path it quantizes each NV weight once and, with fp4-stored weights, the
// activation of every linear.
//
// What bounds it and the design: quantize_fp4_tile.cuh (shared with K1),
// instantiated with qf4::Nv.  The global scale is read from device memory,
// so a scale computed on the card needs no host round trip.  The scale
// arithmetic uses __fmul_rn/__fdiv_rn/__fsqrt_rn in the order of the plain
// version (codecs.nv_*_scale_bytes); the rotation and the QuEST sums are
// summed in the orders of ops/emulation.fused_quantize_nv_ordered_plain, so
// the codes and scale bytes are bit for bit the first design's.
#include "quantize_fp4_tile.cuh"

// layout: 0 = row-major packed [rows, K/2], 1 = K-major packed [K/2, rows].
// Scale byte (row, g) goes to s[g * s_sg + row * s_sr].
extern "C" int qt_quantize_nv(const void* x, const void* h, const void* gs, void* q, void* s,
                              int rows, int k, int rot, int method, int layout, long long s_sg,
                              long long s_sr, void* stream) {
  return (int)qf4::launch<qf4::Nv>((const __nv_bfloat16*)x, (const __nv_bfloat16*)h,
                                   (const float*)gs, (uint8_t*)q, (uint8_t*)s, nullptr, rows, k,
                                   rot, method, layout, s_sg, s_sr, 0, 0, (cudaStream_t)stream);
}
