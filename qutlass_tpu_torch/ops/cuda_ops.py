"""The public MX, NV and QAT ops mapped onto the hand-written kernels
(counterpart of ``qutlass_tpu.ops.pallas_ops``).

Every function here calls a kernel wrapper, which launches the Hopper
kernel for CUDA tensors and runs its plain version for CPU tensors; no
shape is routed around a kernel.
"""
from __future__ import annotations

import torch

from ..kernels import backward as _bwd
from ..kernels import fused_linear as _fl
from ..kernels.gemm import gemm_fp4_mx, gemm_fp4_nv, gemm_fp8_mx
from ..kernels.quantize import (quantize_mx, quantize_mx_int8, quantize_nv,
                                quantize_nv_int8)
from .emulation import tile_scales


def fused_quantize_mx(a, h, *, rot_size: int, method: str = "quest",
                      return_mask: bool = False, layout: str = "rowmajor"):
    return quantize_mx(a, h, rot_size=rot_size, method=method,
                       return_mask=return_mask, layout=layout)


def fused_quantize_mx_int8(a, h, *, rot_size: int, method: str = "quest"):
    return quantize_mx_int8(a.reshape(-1, a.shape[-1]), h, rot_size=rot_size,
                            method=method)


def matmul_mxf4_bf16_tn(a, b, a_sf, b_sf, alpha):
    return gemm_fp4_mx(a, b, a_sf, b_sf, alpha, layout="tn")


def matmul_mxf4_bf16_kmajor(at, bt, a_sft, b_sft, alpha, out_dtype=torch.bfloat16):
    return gemm_fp4_mx(at, bt, a_sft, b_sft, alpha, layout="kmajor", out_dtype=out_dtype)


def matmul_mxf4_bf16_kmajor_codes(at, bt, a_sft, b_sft, alpha):
    return gemm_fp4_mx(at, bt, a_sft, b_sft, alpha, layout="kmajor_codes")


def fused_linear_mxf4(x, wqt, wst, h, alpha, *, rot_size: int, method: str = "quest"):
    return _fl.fused_linear_mx(x, wqt, wst, h, alpha, rot_size=rot_size, method=method)


def fused_quantize_nv(a, h, global_scale, *, rot_size: int,
                      method: str = "abs_max", layout: str = "rowmajor"):
    return quantize_nv(a, h, global_scale, rot_size=rot_size, method=method,
                       layout=layout)


def fused_quantize_nv_int8(a, h, global_scale, *, rot_size: int,
                           method: str = "abs_max"):
    return quantize_nv_int8(a.reshape(-1, a.shape[-1]), h, global_scale,
                            rot_size=rot_size, method=method)


def matmul_nvf4_bf16_tn(a, b, a_sf, b_sf, alpha):
    return gemm_fp4_nv(a, b, a_sf, b_sf, alpha, layout="tn")


def matmul_nvf4_bf16_kmajor(at, bt, a_sft, b_sft, alpha, out_dtype=torch.bfloat16):
    return gemm_fp4_nv(at, bt, a_sft, b_sft, alpha, layout="kmajor", out_dtype=out_dtype)


def fused_linear_nvf4(x, wqt, wst, h, global_scale, alpha, *, rot_size: int,
                      method: str = "abs_max"):
    return _fl.fused_linear_nv(x, wqt, wst, h, global_scale, alpha, rot_size=rot_size,
                               method=method)


def matmul_mxf8_bf16_tn(a, b, a_sf, b_sf, alpha):
    return gemm_fp8_mx(a, b, a_sf, b_sf, alpha, layout="tn")


def matmul_mxf8_bf16_nn(a, b, a_sf, b_sf, alpha):
    return gemm_fp8_mx(a, b, a_sf, b_sf, alpha, layout="nn")


def backward_bf16_square_double_mxfp8(x):
    fp8, eb = _bwd.square_double_mxfp8(x)
    return (fp8, *tile_scales(eb))


def backward_square_double_scaled(x):
    return _bwd.square_double_scaled(x)


def mxfp4_transpose_mxfp8(x_fp4, scales):
    return _bwd.mxfp4_transpose_mxfp8(x_fp4, scales)


def backward_t_bf16(x, h, *, rot_size: int):
    return _bwd.backward_t_bf16(x, h, rot_size=rot_size)


def backward_qt_bf16(x_e2m1, x_e8m0, h, alpha, *, rot_size: int):
    return _bwd.backward_qt_bf16(x_e2m1, x_e8m0, h, alpha, rot_size=rot_size)


def mxfp4_transpose_scaled(x_fp4, scales):
    return _bwd.mxfp4_transpose_scaled(x_fp4, scales)


def mxfp4_transpose_scaled_kmajor(qt, st):
    return _bwd.mxfp4_transpose_scaled_kmajor(qt, st)
