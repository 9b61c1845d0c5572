"""Wrappers of the QAT backward kernels K8/K9 (``csrc/square_double.cu``),
K10, K14 and K15 (``csrc/transpose_mxfp8.cu``) and K12/K13
(``csrc/backward_quant.cu``), counterpart of
``qutlass_tpu.kernels.backward``.

Each wrapper routes by device: tensors on the CPU go to the kernel's
plain version (``*_plain``, in ``ops.emulation``), tensors on a CUDA
device to the kernel, which launches on the current stream into outputs
allocated here.  A launch adds one to ``dispatch.launch_counts``.
"""
from __future__ import annotations

import torch

import math

from ..ops import dispatch
from ..ops import validation as _val
from ..ops.emulation import backward_qt_bf16 as backward_qt_bf16_plain
from ..ops.emulation import backward_square_double_scaled as square_double_scaled_plain
from ..ops.emulation import backward_t_bf16 as backward_t_bf16_plain
from ..ops.emulation import mxfp4_transpose_mxfp8 as mxfp4_transpose_mxfp8_plain
from ..ops.emulation import mxfp4_transpose_scaled as mxfp4_transpose_scaled_plain
from ..ops.emulation import mxfp4_transpose_scaled_kmajor as mxfp4_transpose_scaled_kmajor_plain
from ..ops.emulation import square_double_tiles as square_double_mxfp8_plain
from . import _build


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_square_double(x: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16 or x.ndim != 2:
        raise TypeError(f"x must be a 2-D bfloat16 tensor, got {x.dtype} {tuple(x.shape)}")
    m, n = x.shape
    if m % 32 or n % 32:
        raise ValueError(f"square-double quantization needs M and N multiples of 32, "
                         f"got [{m}, {n}]")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def square_double_scaled(x: torch.Tensor) -> torch.Tensor:
    """Kernel K8: square-double MXFP8 quantization of bf16 x [M, N]
    emitted as the dequantized bf16 [M, N]; the contract of
    :func:`square_double_scaled_plain`."""
    if not dispatch.on_cuda(x):
        return square_double_scaled_plain(x)
    _check_square_double(x)
    m, n = x.shape
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    err = _build.library().qt_square_double(x.data_ptr(), None, None, out.data_ptr(),
                                            m, n, 1, _stream(x))
    _build.check(err, "square_double_scaled")
    dispatch.note_launch("square_double_scaled")
    return out


def square_double_mxfp8(x: torch.Tensor):
    """Kernel K9: square-double MXFP8 quantization of bf16 x [M, N] ->
    (e4m3 bytes u8 [M, N], tile exponent bytes u8 [M/32, N/32]); the
    contract of :func:`square_double_mxfp8_plain`."""
    if not dispatch.on_cuda(x):
        return square_double_mxfp8_plain(x)
    _check_square_double(x)
    m, n = x.shape
    fp8 = torch.empty((m, n), dtype=torch.uint8, device=x.device)
    eb = torch.empty((m // 32, n // 32), dtype=torch.uint8, device=x.device)
    err = _build.library().qt_square_double(x.data_ptr(), fp8.data_ptr(), eb.data_ptr(),
                                            None, m, n, 0, _stream(x))
    _build.check(err, "square_double_mxfp8")
    dispatch.note_launch("square_double_mxfp8")
    return fp8, eb


def _check_fp4_rowmajor(name: str, x_fp4: torch.Tensor, scales: torch.Tensor):
    """Validate an MXFP4 operand for K10/K14; return (M, N)."""
    for arg, t in (("x_fp4", x_fp4), ("scales", scales)):
        if t.dtype != torch.uint8 or t.ndim != 2:
            raise TypeError(f"{arg} must be a 2-D uint8 tensor, got {t.dtype} "
                            f"{tuple(t.shape)}")
    m, n = x_fp4.shape[0], x_fp4.shape[1] * 2
    if m % 32 or n % 32:
        raise ValueError(f"{name} needs M and N multiples of 32, got [{m}, {n}]")
    if tuple(scales.shape) != (m, n // 32):
        raise ValueError(f"scales {tuple(scales.shape)} do not match [{m}, {n // 32}]")
    if not x_fp4.is_contiguous():
        raise ValueError("x_fp4 must be contiguous")
    return m, n


def _transpose(x_fp4, scales, fp8, eb, out, m, n):
    return _build.library().qt_mxfp4_transpose_mxfp8(
        x_fp4.data_ptr(), scales.data_ptr(), scales.stride(0), scales.stride(1),
        fp8, eb, out, m, n, _stream(x_fp4))


def mxfp4_transpose_mxfp8(x_fp4: torch.Tensor, scales: torch.Tensor):
    """Kernel K10: MXFP4 packed u8 [M, N/2] with e8m0 bytes [M, N/32]
    (any strides) -> (e4m3 bytes u8 [N, M], exponent bytes u8 [N, M/32]),
    requantized in 32-groups along M; the contract of
    :func:`mxfp4_transpose_mxfp8_plain`.  M and N multiples of 32."""
    if not dispatch.on_cuda(x_fp4, scales):
        return mxfp4_transpose_mxfp8_plain(x_fp4, scales)
    m, n = _check_fp4_rowmajor("mxfp4_transpose_mxfp8", x_fp4, scales)
    fp8 = torch.empty((n, m), dtype=torch.uint8, device=x_fp4.device)
    eb = torch.empty((n, m // 32), dtype=torch.uint8, device=x_fp4.device)
    err = _transpose(x_fp4, scales, fp8.data_ptr(), eb.data_ptr(), None, m, n)
    _build.check(err, "mxfp4_transpose_mxfp8")
    dispatch.note_launch("mxfp4_transpose_mxfp8")
    return fp8, eb


def mxfp4_transpose_scaled(x_fp4: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Kernel K14: K10's quantization points emitted as ``e4m3_value *
    2^(e-127)`` in bf16 [N, M]; the contract of
    :func:`mxfp4_transpose_scaled_plain`.  M and N multiples of 32."""
    if not dispatch.on_cuda(x_fp4, scales):
        return mxfp4_transpose_scaled_plain(x_fp4, scales)
    m, n = _check_fp4_rowmajor("mxfp4_transpose_scaled", x_fp4, scales)
    out = torch.empty((n, m), dtype=torch.bfloat16, device=x_fp4.device)
    err = _transpose(x_fp4, scales, None, None, out.data_ptr(), m, n)
    _build.check(err, "mxfp4_transpose_scaled")
    dispatch.note_launch("mxfp4_transpose_scaled")
    return out


def mxfp4_transpose_scaled_kmajor(qt: torch.Tensor, st: torch.Tensor) -> torch.Tensor:
    """Kernel K15: the K-major MXFP4 operand (packed u8 [K/2, rows],
    e8m0 u8 [K/32, rows]) -> bf16 [K, rows], K14's points along the rows
    (a last partial group zero-padded); the contract of
    :func:`mxfp4_transpose_scaled_kmajor_plain`.  K a multiple of 32."""
    if not dispatch.on_cuda(qt, st):
        return mxfp4_transpose_scaled_kmajor_plain(qt, st)
    for name, t in (("qt", qt), ("st", st)):
        if t.dtype != torch.uint8 or t.ndim != 2 or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous 2-D uint8 tensor, got {t.dtype} "
                            f"{tuple(t.shape)}")
    k, rows = qt.shape[0] * 2, qt.shape[1]
    if k % 32 or tuple(st.shape) != (k // 32, rows):
        raise ValueError(f"K-major operand {tuple(qt.shape)} with scales {tuple(st.shape)}: "
                         f"K={k} must be a multiple of 32 and the scales [{k // 32}, {rows}]")
    out = torch.empty((k, rows), dtype=torch.bfloat16, device=qt.device)
    err = _build.library().qt_mxfp4_transpose_scaled_kmajor(
        qt.data_ptr(), st.data_ptr(), out.data_ptr(), k, rows, _stream(qt))
    _build.check(err, "mxfp4_transpose_scaled_kmajor")
    dispatch.note_launch("mxfp4_transpose_scaled_kmajor")
    return out


def _check_rot(h: torch.Tensor, rot_size: int, r: int, name: str) -> torch.Tensor:
    """The rotation as contiguous bf16 [rot, rot]; the rotated axis (R)
    a multiple of 32 and of rot."""
    if _val.check_rotation(h, r) != rot_size or r % 32:
        raise ValueError(f"{name}: the rotated axis ({r}) must be a multiple of 32, and the "
                         f"rotation {tuple(h.shape)} [{rot_size}, {rot_size}]")
    return h.to(torch.bfloat16).contiguous()


def backward_t_bf16(x: torch.Tensor, h: torch.Tensor, *, rot_size: int):
    """Kernel K12: bf16 x [..., N, K] (contiguous) -> (packed u8 [..., K,
    N/2], e8m0 u8 [..., K, N/32]); the contract of
    :func:`backward_t_bf16_plain`.  N a multiple of 32 and of rot."""
    if not dispatch.on_cuda(x, h):
        return backward_t_bf16_plain(x, h, rot_size=rot_size)
    if x.dtype != torch.bfloat16 or x.ndim < 2 or not x.is_contiguous():
        raise TypeError(f"x must be a contiguous bfloat16 tensor [..., N, K], got {x.dtype} "
                        f"{tuple(x.shape)}")
    *lead, n, k = x.shape
    hb = _check_rot(h, rot_size, n, "backward_t_bf16")
    q = torch.empty((*lead, k, n // 2), dtype=torch.uint8, device=x.device)
    s = torch.empty((*lead, k, n // 32), dtype=torch.uint8, device=x.device)
    err = _build.library().qt_backward_t(x.data_ptr(), hb.data_ptr(), q.data_ptr(),
                                         s.data_ptr(), n, k, rot_size, math.prod(lead),
                                         _stream(x))
    _build.check(err, "backward_t_bf16")
    dispatch.note_launch("backward_t_bf16")
    return q, s


def backward_qt_bf16(x_e2m1: torch.Tensor, x_e8m0: torch.Tensor, h: torch.Tensor,
                     alpha, *, rot_size: int):
    """Kernel K13: MXFP4 [..., M, N] (packed u8 [..., M, N/2] contiguous,
    e8m0 u8 [..., M, N/32] with any strides) and alpha (a number or a
    1-element tensor, kept on the card) -> (packed u8 [..., N, M/2], e8m0
    u8 [..., N, M/32]); the contract of :func:`backward_qt_bf16_plain`.
    M a multiple of 32 and of rot, N of 32."""
    al = torch.as_tensor(alpha, dtype=torch.float32, device=x_e2m1.device).reshape(())
    if not dispatch.on_cuda(x_e2m1, x_e8m0, h, al):
        return backward_qt_bf16_plain(x_e2m1, x_e8m0, h, al, rot_size=rot_size)
    for name, t in (("x_e2m1", x_e2m1), ("x_e8m0", x_e8m0)):
        if t.dtype != torch.uint8 or t.ndim < 2:
            raise TypeError(f"{name} must be a uint8 tensor [..., rows, cols], got {t.dtype} "
                            f"{tuple(t.shape)}")
    *lead, m, n2 = x_e2m1.shape
    n = n2 * 2
    if n % 32 or tuple(x_e8m0.shape) != (*lead, m, n // 32):
        raise ValueError(f"x_e8m0 {tuple(x_e8m0.shape)} does not match "
                         f"{(*lead, m, n // 32)} (N={n} a multiple of 32)")
    if not x_e2m1.is_contiguous():
        raise ValueError("x_e2m1 must be contiguous")
    hb = _check_rot(h, rot_size, m, "backward_qt_bf16")
    batch = math.prod(lead)
    sf = x_e8m0.reshape(batch, m, n // 32)      # a view for any batch-uniform strides
    q = torch.empty((*lead, n, m // 2), dtype=torch.uint8, device=x_e2m1.device)
    s = torch.empty((*lead, n, m // 32), dtype=torch.uint8, device=x_e2m1.device)
    err = _build.library().qt_backward_qt(
        x_e2m1.data_ptr(), sf.data_ptr(), sf.stride(0), sf.stride(1), sf.stride(2),
        al.data_ptr(), hb.data_ptr(), q.data_ptr(), s.data_ptr(), m, n, rot_size, batch,
        _stream(x_e2m1))
    _build.check(err, "backward_qt_bf16")
    dispatch.note_launch("backward_qt_bf16")
    return q, s
