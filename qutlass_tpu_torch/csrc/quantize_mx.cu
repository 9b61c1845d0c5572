// K1 quantize_mx: fused rotation + MXFP4 quantization (group 32, e8m0).
//
// Replaces the Pallas kernel qutlass_tpu/kernels/quantize.py:
// fused_quantize_mx (body _quantize_mx_kernel, :81-114).  On the serving
// path it quantizes each MX weight once and, with fp4-stored weights, the
// activation of every linear; on the QAT path the forward's activation
// (with the clip mask) and weights.
//
// What bounds it and the design: quantize_fp4_tile.cuh (shared with K5),
// instantiated with qf4::Mx.  Bit for bit the first design's codes, scale
// bytes and mask bytes, which ops/emulation.fused_quantize_mx_ordered_plain
// writes out in plain PyTorch.
#include "quantize_fp4_tile.cuh"

// layout: 0 = row-major packed [rows, K/2], 1 = K-major packed [K/2, rows],
// 2 = K-major codes [K, rows].  Scale byte (row, g) goes to
// s[g * s_sg + row * s_sr]; mask byte (row, j) to m[j * m_sj + row * m_sr].
extern "C" int qt_quantize_mx(const void* x, const void* h, void* q, void* s, void* mask, int rows,
                              int k, int rot, int method, int layout, long long s_sg,
                              long long s_sr, long long m_sj, long long m_sr, void* stream) {
  return (int)qf4::launch<qf4::Mx>((const __nv_bfloat16*)x, (const __nv_bfloat16*)h, nullptr,
                                   (uint8_t*)q, (uint8_t*)s, (uint8_t*)mask, rows, k, rot, method,
                                   layout, s_sg, s_sr, m_sj, m_sr, (cudaStream_t)stream);
}

extern "C" const char* qt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
