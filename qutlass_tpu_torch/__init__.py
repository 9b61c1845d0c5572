"""qutlass_tpu_torch — the MXFP4 and NVFP4 W4A4 serving paths, the
single-kernel quantized linear and the Quartet QAT training path of
``qutlass_tpu`` in PyTorch, with hand-written CUDA kernels for the NVIDIA
H100 (sm_90a).

Same op names, argument conventions and stored bytes as the JAX package:

  * e2m1 data: ``uint8``, two values per byte, element 2i in the low nibble
  * e4m3 data (MXFP8, the QAT backward): ``uint8`` bytes
  * e8m0 scales (MX, group 32) and e4m3 scales (NV, group 16): ``uint8``
    bytes (``torch.float8_e8m0fnu`` / ``float8_e4m3fn`` views are
    accepted)
  * K-major operands are ``[K, rows]``; row-major scales ``[rows, K/gs]``
  * an NV global scale or a GEMM alpha: a number, or a 0-dim or
    1-element fp32 tensor (kept on the card when it lies there)

Tensors on a CUDA device run the kernels in ``qutlass_tpu_torch/csrc``
(built with ``nvcc`` at first use); tensors on the CPU run each kernel's
plain PyTorch version (``ops/emulation.py``).  The package never imports
JAX.
"""
from __future__ import annotations

import torch

from . import utils
from .formats import codecs
from .ops import cuda_ops as _ops
from .ops import dispatch
from .ops import emulation as _emu
from .ops import validation as _val
from .utils import (ceil_div, dct_matrix, from_blocked, get_padded_shape_mx,
                    get_padded_shape_nv, hadamard_matrix, identity_matrix, pad_to_block,
                    round_up, to_blocked, to_blocked_swizzled)

__version__ = "0.1.0"

__all__ = [
    "fusedQuantizeMx", "fusedQuantizeMxInt8", "fused_quantize_mx",
    "fused_quantize_mx_int8", "matmul_mxf4_bf16_tn", "matmul_mxf4_bf16_kmajor",
    "matmul_mxf4_bf16_kmajor_codes", "matmul_ada_mxf4_bf16_tn", "fused_linear_mxf4",
    "fusedQuantizeNv", "fusedQuantizeNvInt8", "fused_quantize_nv",
    "fused_quantize_nv_int8", "matmul_nvf4_bf16_tn", "matmul_nvf4_bf16_kmajor",
    "fused_linear_nvf4",
    "matmul_mxf8_bf16_tn", "matmul_mxf8_bf16_nn",
    "backward_bf16_square_double_mxfp8", "backward_square_double_scaled",
    "mxfp4_transpose_mxfp8", "backward_t_bf16", "backward_qt_bf16",
    "mxfp4_transpose_scaled", "mxfp4_transpose_scaled_kmajor",
    "to_blocked", "to_blocked_swizzled", "from_blocked", "pad_to_block",
    "get_padded_shape_mx", "get_padded_shape_nv", "hadamard_matrix", "dct_matrix",
    "identity_matrix",
]


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    """Accept float8 views and int32 byte values; return uint8."""
    if x.dtype == torch.uint8:
        return x
    if x.dtype in (torch.float8_e8m0fnu, torch.float8_e4m3fn):
        return x.view(torch.uint8)
    if x.dtype == torch.int32:
        return x.to(torch.uint8)
    raise TypeError(f"expected uint8 byte tensor, got {x.dtype}")


def _norm_scales(sf: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Normalize a scale argument to row-major [rows, cols] bytes.

    Accepts the flattened padded layout of :func:`to_blocked`, the padded
    2-D buffer of the quantizers, or the exact [rows, cols] matrix.  A
    padded buffer is sliced, not copied.
    """
    sf = _as_bytes(sf)
    if sf.ndim == 1:
        for pc in (round_up(cols, 4), cols):
            if sf.numel() % pc == 0 and sf.numel() >= rows * pc:
                sf = sf.reshape(-1, pc)
                break
        else:
            raise ValueError(
                f"flattened scale buffer of {sf.numel()} bytes cannot cover "
                f"[{rows}, {cols}] (expected row padding to a multiple of "
                f"{round_up(cols, 4)} or {cols} columns)")
    if sf.ndim != 2:
        raise ValueError(f"scales must be 1-D or 2-D, got shape {tuple(sf.shape)}")
    if sf.shape[0] > rows or sf.shape[1] > cols:
        sf = sf[:rows, :cols]
    if tuple(sf.shape) != (rows, cols):
        raise ValueError(
            f"scale buffer shape {tuple(sf.shape)} does not cover the required "
            f"[{rows}, {cols}] (pass the quantizer's padded buffer, a "
            f"to_blocked flattening, or the exact matrix)")
    return sf


def _check_method(method: str) -> None:
    if method not in ("quest", "abs_max"):
        raise ValueError(f"invalid method {method!r}, must be 'quest' or 'abs_max'")


def _tn_impl(backend: str | None, kernel_route, plain):
    """The tn GEMMs' ``backend``: None runs the device route (the kernel
    for CUDA tensors, its plain version for CPU ones), "emulation" the
    plain version on any device because the caller asks for it."""
    if backend is None:
        return kernel_route
    if backend == "emulation":
        return plain
    raise ValueError(f"invalid backend {backend!r}, must be None or 'emulation'")


# ---------------------------------------------------------------------------
# fused quantization
# ---------------------------------------------------------------------------

def fusedQuantizeMx(a: torch.Tensor, h: torch.Tensor, *, method: str = "quest",
                    return_mask: bool = False, layout: str = "rowmajor"):
    """Fused rotation + MXFP4 quantization.

    a: [..., K] bf16; h: [r, r] rotation, r in {16, 32, 64, 128},
    K % r == 0, K % 32 == 0.  Returns (e2m1 u8 [..., K/2], e8m0 u8
    [pad_rows, pad_cols][, clip_mask u8 [..., K/8]]).  ``layout="kmajor"``
    returns (e2m1 u8 [K/2, rows], e8m0 u8 [K/32, rows][, mask u8
    [K/8, rows]]); ``layout="kmajor_codes"`` unpacked codes u8 [K, rows].
    """
    _check_method(method)
    if return_mask and method != "quest":
        raise ValueError("return_mask is only supported for method 'quest'")
    if layout not in ("rowmajor", "kmajor", "kmajor_codes"):
        raise ValueError(f"invalid layout {layout!r}")
    _val.check_bf16("a", a)
    k = a.shape[-1]
    rot = _val.check_rotation(h, k)
    _val.check_group_dim("fusedQuantizeMx", k, 32)
    return _ops.fused_quantize_mx(a.contiguous(), h, rot_size=rot, method=method,
                                  return_mask=return_mask, layout=layout)


def fusedQuantizeMxInt8(a: torch.Tensor, h: torch.Tensor, *,
                        method: str = "quest"):
    """Fused rotation + MXFP4 quantization + int8 encode (the activation
    path of the int8 evaluator, ``ops/int8path.py``).

    Returns (a' int8 [K, rows] natural K order, row_scale f32 [rows] =
    2^(E-4), e8m0 scale bytes u8 [K/32, rows]).
    """
    _check_method(method)
    _val.check_bf16("a", a)
    k = a.shape[-1]
    rot = _val.check_rotation(h, k)
    _val.check_group_dim("fusedQuantizeMxInt8", k, 32)
    return _ops.fused_quantize_mx_int8(a.contiguous(), h, rot_size=rot,
                                       method=method)


def fusedQuantizeNv(a: torch.Tensor, h: torch.Tensor, global_scale, *,
                    method: str = "abs_max", layout: str = "rowmajor"):
    """Fused rotation + NVFP4 quantization (group 16, e4m3 scales).

    a: [..., K] bf16, K % 16 == 0; h: [r, r] rotation.  Returns (e2m1 u8
    [..., K/2], e4m3 u8 padded [round_up(rows, 128), round_up(K/16, 4)]);
    ``layout="kmajor"`` returns (e2m1 u8 [K/2, rows], e4m3 u8 [K/16,
    rows]) for :func:`matmul_nvf4_bf16_kmajor`.  abs-max scales are
    ``e4m3(global_scale * amax / 6)``.
    """
    _check_method(method)
    if layout not in ("rowmajor", "kmajor"):
        raise ValueError(f"invalid layout {layout!r}")
    _val.check_bf16("a", a)
    k = a.shape[-1]
    rot = _val.check_rotation(h, k)
    _val.check_group_dim("fusedQuantizeNv", k, 16)
    return _ops.fused_quantize_nv(a.contiguous(), h, global_scale, rot_size=rot,
                                  method=method, layout=layout)


def fusedQuantizeNvInt8(a: torch.Tensor, h: torch.Tensor, global_scale, *,
                        method: str = "abs_max"):
    """Fused rotation + NVFP4 quantization + int8 encode (the activation
    path of the NV int8 evaluator, ``ops/int8path.py``).

    Returns (a' int8 [K, rows] natural K order, sigma f32 [rows], e4m3
    scale bytes u8 [K/16, rows]); the encode rounds by at most sigma/2
    per element.
    """
    _check_method(method)
    _val.check_bf16("a", a)
    k = a.shape[-1]
    rot = _val.check_rotation(h, k)
    _val.check_group_dim("fusedQuantizeNvInt8", k, 16)
    return _ops.fused_quantize_nv_int8(a.contiguous(), h, global_scale,
                                       rot_size=rot, method=method)


fused_quantize_mx = fusedQuantizeMx
fused_quantize_mx_int8 = fusedQuantizeMxInt8
fused_quantize_nv = fusedQuantizeNv
fused_quantize_nv_int8 = fusedQuantizeNvInt8


# ---------------------------------------------------------------------------
# block-scaled GEMMs
# ---------------------------------------------------------------------------

def matmul_mxf4_bf16_tn(a, b, a_sf, b_sf, alpha, backend: str | None = None):
    """out[M, N] = (dq(a) @ dq(b)^T) * alpha in bf16.

    a: u8 [M, K/2], b: u8 [N, K/2]; scales row-major (or the flattened
    padded layout from :func:`to_blocked`).  ``backend="emulation"`` runs
    the plain version on the tensors' device.
    """
    impl = _tn_impl(backend, _ops.matmul_mxf4_bf16_tn, _emu.matmul_mxf4_bf16_tn)
    m, n, k = _val.check_matmul_tn(a, b, 32)
    a_sf = _norm_scales(a_sf, m, k // 32)
    b_sf = _norm_scales(b_sf, n, k // 32)
    return impl(_as_bytes(a), _as_bytes(b), a_sf, b_sf, alpha)


def matmul_mxf4_bf16_kmajor(at, bt, a_sft, b_sft, alpha, out_dtype=torch.bfloat16):
    """K-major MXFP4 GEMM: at u8 [K/2, M], bt u8 [K/2, N], scales u8
    [K/32, M] / [K/32, N] (``fusedQuantizeMx(..., layout="kmajor")``);
    ``out_dtype`` bf16 or fp32 (the fp32 result, not rounded)."""
    return _ops.matmul_mxf4_bf16_kmajor(_as_bytes(at), _as_bytes(bt),
                                        _as_bytes(a_sft), _as_bytes(b_sft),
                                        alpha, out_dtype=out_dtype)


def matmul_mxf4_bf16_kmajor_codes(at, bt, a_sft, b_sft, alpha):
    """K-major MXFP4 GEMM with unpacked activation codes at u8 [K, M]."""
    return _ops.matmul_mxf4_bf16_kmajor_codes(_as_bytes(at), _as_bytes(bt),
                                              _as_bytes(a_sft),
                                              _as_bytes(b_sft), alpha)


def _mx_linear_alpha(alpha, method: str):
    """alpha (None for 1) of the MX linear, times float32(1/9) in fp32 for
    abs-max (the 3x of both operands).  A number stays a host number (K4
    takes it by value, K16 fills a device scalar) and a tensor stays where
    it lies, so no route copies it to the card or syncs."""
    alpha = 1.0 if alpha is None else alpha
    if method == "quest":
        return alpha
    ninth = torch.tensor(1.0 / 9.0, dtype=torch.float32)
    if isinstance(alpha, torch.Tensor):
        return alpha.to(torch.float32) * ninth
    return float(torch.tensor(alpha, dtype=torch.float32) * ninth)


def fused_linear_mxf4(x, wqt, wst, h, alpha=None, *, method: str = "quest"):
    """W4A4 MXFP4 linear against a pre-quantized K-major weight:
    y [..., N] = bf16(dq(q(x H)) @ dq(w)^T * alpha), alpha (default 1)
    times 1/9 for abs-max.

    x: [..., K] bf16; wqt/wst from ``fusedQuantizeMx(w, h,
    layout="kmajor")`` (packed u8 [K/2, N], e8m0 u8 [K/32, N]).  Runs as
    the composition of K1 (K-major) and K4 unless the environment sets
    ``QUTLASS_TPU_FUSED_LINEAR`` (to anything but "" or "0"), which runs
    the single kernel K16; both give the same bits.
    """
    _check_method(method)
    wqt, wst = _as_bytes(wqt), _as_bytes(wst)
    al = _mx_linear_alpha(alpha, method)
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if dispatch.fused_linear_single_kernel():      # K16's wrapper validates
        y = _ops.fused_linear_mxf4(x2, wqt, wst, h, al, rot_size=h.shape[-1], method=method)
    else:
        rot = _val.check_fused_linear("fused_linear_mxf4", x, h, wqt, wst, 32)
        xqt, xst = _ops.fused_quantize_mx(x2, h, rot_size=rot, method=method, layout="kmajor")
        y = _ops.matmul_mxf4_bf16_kmajor(xqt, wqt, xst, wst, al)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def matmul_ada_mxf4_bf16_tn(a, b, a_sf, b_sf, alpha):
    """Small-batch alias of :func:`matmul_mxf4_bf16_tn` (one kernel covers
    both regimes)."""
    return matmul_mxf4_bf16_tn(a, b, a_sf, b_sf, alpha)


def matmul_nvf4_bf16_tn(a, b, a_sf, b_sf, alpha, backend: str | None = None):
    """NVFP4 GEMM: out[M, N] = (dq(a) @ dq(b)^T) * alpha in bf16.

    a: u8 [M, K/2], b: u8 [N, K/2]; e4m3 scales row-major [rows, K/16]
    (or the quantizer's padded buffer, or its :func:`to_blocked`
    flattening).  ``backend="emulation"`` runs the plain version on the
    tensors' device.
    """
    impl = _tn_impl(backend, _ops.matmul_nvf4_bf16_tn, _emu.matmul_nvf4_bf16_tn)
    m, n, k = _val.check_matmul_tn(a, b, 16)
    a_sf = _norm_scales(a_sf, m, k // 16)
    b_sf = _norm_scales(b_sf, n, k // 16)
    return impl(_as_bytes(a), _as_bytes(b), a_sf, b_sf, alpha)


def matmul_nvf4_bf16_kmajor(at, bt, a_sft, b_sft, alpha, out_dtype=torch.bfloat16):
    """K-major NVFP4 GEMM: at u8 [K/2, M], bt u8 [K/2, N], e4m3 scales u8
    [K/16, M] / [K/16, N] (``fusedQuantizeNv(..., layout="kmajor")``);
    ``out_dtype`` bf16 or fp32 (the fp32 result, not rounded)."""
    return _ops.matmul_nvf4_bf16_kmajor(_as_bytes(at), _as_bytes(bt),
                                        _as_bytes(a_sft), _as_bytes(b_sft),
                                        alpha, out_dtype=out_dtype)


def fused_linear_nvf4(x, wqt, wst, h, global_scale, alpha=None, *,
                      method: str = "abs_max"):
    """W4A4 NVFP4 linear against a pre-quantized K-major weight: x [...,
    K] bf16 quantized in 16-groups under the activation ``global_scale``,
    wqt/wst from ``fusedQuantizeNv(w, h, gs_w, layout="kmajor")`` (packed
    u8 [K/2, N], e4m3 u8 [K/16, N]); fold both global scales into
    ``alpha`` (default 1).  The composition K5 (K-major) + K7, or under
    ``QUTLASS_TPU_FUSED_LINEAR`` the single kernel K17: the same bits.
    """
    _check_method(method)
    wqt, wst = _as_bytes(wqt), _as_bytes(wst)
    al = 1.0 if alpha is None else alpha
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if dispatch.fused_linear_single_kernel():      # K17's wrapper validates
        y = _ops.fused_linear_nvf4(x2, wqt, wst, h, global_scale, al, rot_size=h.shape[-1],
                                   method=method)
    else:
        rot = _val.check_fused_linear("fused_linear_nvf4", x, h, wqt, wst, 16)
        gs = _val.check_global_scale(global_scale, x.device)
        xqt, xst = _ops.fused_quantize_nv(x2, h, gs, rot_size=rot, method=method,
                                          layout="kmajor")
        y = _ops.matmul_nvf4_bf16_kmajor(xqt, wqt, xst, wst, al)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def matmul_mxf8_bf16_tn(a, b, a_sf, b_sf, alpha):
    """MXFP8 GEMM, TN: out[M, N] = (dq(a) @ dq(b)^T) * alpha in bf16.

    a: e4m3 bytes [M, K], b: [N, K]; e8m0 scales [M, K/32] / [N, K/32]
    (or a padded buffer, or its :func:`to_blocked` flattening).
    """
    a, b = _as_bytes(a), _as_bytes(b)
    k = _val.check_matmul_fp8(a, b, 1)
    return _ops.matmul_mxf8_bf16_tn(a, b, _norm_scales(a_sf, a.shape[0], k // 32),
                                    _norm_scales(b_sf, b.shape[0], k // 32), alpha)


def matmul_mxf8_bf16_nn(a, b, a_sf, b_sf, alpha):
    """MXFP8 GEMM, NN: ``a`` stored [K, M] (the logical A^T, as the QAT
    wgrad holds dY), its scales [M, K/32] for the logical A; b [N, K]."""
    a, b = _as_bytes(a), _as_bytes(b)
    k = _val.check_matmul_fp8(a, b, 0)
    return _ops.matmul_mxf8_bf16_nn(a, b, _norm_scales(a_sf, a.shape[1], k // 32),
                                    _norm_scales(b_sf, b.shape[0], k // 32), alpha)


# ---------------------------------------------------------------------------
# QAT backward ops
# ---------------------------------------------------------------------------

def backward_bf16_square_double_mxfp8(x_bf16):
    """32x32-tile double quantization of dY [M, N] to MXFP8, M padded with
    zero rows to a multiple of 128.  Returns (e4m3 bytes u8 [Mp, N], row
    scales u8 [Mp, N/32], col scales u8 [N, Mp/32])."""
    _val.check_bf16("x", x_bf16)
    x = pad_to_block(x_bf16, [0], 128).contiguous()
    _val.check_tiles_32("backward_bf16_square_double_mxfp8", *x.shape)
    return _ops.backward_bf16_square_double_mxfp8(x)


def backward_square_double_scaled(x_bf16):
    """The same quantization points as
    :func:`backward_bf16_square_double_mxfp8`, returned as
    ``e4m3_value * 2^(scale-127)`` in bf16 [Mp, N]."""
    _val.check_bf16("x", x_bf16)
    x = pad_to_block(x_bf16, [0], 128).contiguous()
    _val.check_tiles_32("backward_square_double_scaled", *x.shape)
    return _ops.backward_square_double_scaled(x)


def _pad_rows_256(x_fp4: torch.Tensor, scales, name: str):
    """The MXFP4 operand [M, N] with M padded to a multiple of 256: zero
    codes under unit scales (byte 127), as the JAX ops pad it."""
    x_fp4 = _as_bytes(x_fp4)
    m, n = x_fp4.shape[0], x_fp4.shape[1] * 2
    rows = min(m, scales.shape[0]) if scales.ndim == 2 else m
    scales = _norm_scales(scales, rows, n // 32)
    mp = round_up(m, 256)
    if mp != m:
        x_fp4 = pad_to_block(x_fp4, [0], 256)
    if scales.shape[0] < mp:
        pad = torch.full((mp - scales.shape[0], n // 32), 127, dtype=torch.uint8,
                         device=scales.device)
        scales = torch.cat([scales, pad], dim=0)
    _val.check_tiles_32(name, mp, n)
    return x_fp4.contiguous(), scales


def mxfp4_transpose_mxfp8(x_fp4, scales):
    """Dequantize MXFP4 [M, N] (packed u8 [M, N/2], e8m0 scales [M, N/32]
    or the quantizer's padded buffer), transpose, and requantize in
    32-groups along M to MXFP8.  M is padded to a multiple of 256 with
    zero codes under unit scales (byte 127).  Returns (e4m3 bytes u8
    [N, Mp], e8m0 u8 [N, Mp/32])."""
    return _ops.mxfp4_transpose_mxfp8(*_pad_rows_256(x_fp4, scales,
                                                     "mxfp4_transpose_mxfp8"))


def mxfp4_transpose_scaled(x_fp4, scales):
    """The quantization points of :func:`mxfp4_transpose_mxfp8` (the same
    padding of M to 256) returned as ``e4m3_value * 2^(scale-127)`` in
    bf16 [N, Mp], the operand of plain bf16 GEMMs."""
    return _ops.mxfp4_transpose_scaled(*_pad_rows_256(x_fp4, scales,
                                                      "mxfp4_transpose_scaled"))


def mxfp4_transpose_scaled_kmajor(qt, st):
    """:func:`mxfp4_transpose_scaled` from the K-major operand of
    ``fusedQuantizeMx(..., layout="kmajor")``: packed u8 [K/2, rows], e8m0
    u8 [K/32, rows] -> bf16 [K, rows], for any row count."""
    qt, st = _as_bytes(qt), _as_bytes(st)
    _val.check_kmajor_mx("mxfp4_transpose_scaled_kmajor", qt, st)
    return _ops.mxfp4_transpose_scaled_kmajor(qt.contiguous(), st.contiguous())


def backward_t_bf16(x, h):
    """Transpose, rotate along N and quantize to MXFP4 in 32-groups along
    N with abs-max scales (no +1e-8): the QAT wgrad operand.  x bf16
    [..., N, K] -> (e2m1 u8 [..., K, N/2], e8m0 u8 [..., K, N/32]); N a
    multiple of 32 and of the rotation size."""
    _val.check_bf16("x", x)
    _val.check_backward_rows("backward_t_bf16", x.shape, h)
    return _ops.backward_t_bf16(x.contiguous(), h, rot_size=h.shape[-1])


def backward_qt_bf16(x_e2m1, x_e8m0, h, alpha):
    """Dequantize MXFP4 [..., M, N] without alpha, transpose, rotate along
    M and requantize in 32-groups along M: scale bytes pow2floor(amax /
    alpha), values times 3 / (scale * alpha).  x_e2m1 u8 [..., M, N/2];
    x_e8m0 [..., M, N/32] or, for 2-D operands, the quantizer's padded
    buffer (sliced).  Returns (e2m1 u8 [..., N, M/2], e8m0 u8 [..., N,
    M/32])."""
    x_e2m1, x_e8m0 = _as_bytes(x_e2m1), _as_bytes(x_e8m0)
    if x_e2m1.ndim < 2:
        raise ValueError(f"x_e2m1 must be [..., M, N/2], got {tuple(x_e2m1.shape)}")
    m, n = x_e2m1.shape[-2], x_e2m1.shape[-1] * 2
    if x_e2m1.ndim == 2:
        x_e8m0 = _norm_scales(x_e8m0, m, n // 32)
    elif x_e8m0.ndim == x_e2m1.ndim:
        x_e8m0 = x_e8m0[..., :m, :n // 32]
    if tuple(x_e8m0.shape) != (*x_e2m1.shape[:-1], n // 32):
        raise ValueError(f"x_e8m0 {tuple(x_e8m0.shape)} does not cover "
                         f"{(*x_e2m1.shape[:-1], n // 32)}")
    _val.check_group_dim("backward_qt_bf16", n, 32)
    _val.check_backward_rows("backward_qt_bf16", (*x_e2m1.shape[:-1], n), h)
    return _ops.backward_qt_bf16(x_e2m1.contiguous(), x_e8m0, h, alpha,
                                 rot_size=h.shape[-1])
