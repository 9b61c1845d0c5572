"""Wrappers of the QAT backward kernels K8/K9 (``csrc/square_double.cu``)
and K10 (``csrc/transpose_mxfp8.cu``), counterpart of
``qutlass_tpu.kernels.backward``.

Each wrapper routes by device: tensors on the CPU go to the kernel's
plain version (``*_plain``, in ``ops.emulation``), tensors on a CUDA
device to the kernel, which launches on the current stream into outputs
allocated here.  A launch adds one to ``dispatch.launch_counts``.
"""
from __future__ import annotations

import torch

from ..ops import dispatch
from ..ops.emulation import backward_square_double_scaled as square_double_scaled_plain
from ..ops.emulation import mxfp4_transpose_mxfp8 as mxfp4_transpose_mxfp8_plain
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


def mxfp4_transpose_mxfp8(x_fp4: torch.Tensor, scales: torch.Tensor):
    """Kernel K10: MXFP4 packed u8 [M, N/2] with e8m0 bytes [M, N/32]
    (any strides) -> (e4m3 bytes u8 [N, M], exponent bytes u8 [N, M/32]),
    requantized in 32-groups along M; the contract of
    :func:`mxfp4_transpose_mxfp8_plain`.  M and N multiples of 32."""
    if not dispatch.on_cuda(x_fp4, scales):
        return mxfp4_transpose_mxfp8_plain(x_fp4, scales)
    for name, t in (("x_fp4", x_fp4), ("scales", scales)):
        if t.dtype != torch.uint8 or t.ndim != 2:
            raise TypeError(f"{name} must be a 2-D uint8 tensor, got {t.dtype} "
                            f"{tuple(t.shape)}")
    m, n = x_fp4.shape[0], x_fp4.shape[1] * 2
    if m % 32 or n % 32:
        raise ValueError(f"mxfp4_transpose_mxfp8 needs M and N multiples of 32, got "
                         f"[{m}, {n}]")
    if tuple(scales.shape) != (m, n // 32):
        raise ValueError(f"scales {tuple(scales.shape)} do not match [{m}, {n // 32}]")
    if not x_fp4.is_contiguous():
        raise ValueError("x_fp4 must be contiguous")
    fp8 = torch.empty((n, m), dtype=torch.uint8, device=x_fp4.device)
    eb = torch.empty((n, m // 32), dtype=torch.uint8, device=x_fp4.device)
    err = _build.library().qt_mxfp4_transpose_mxfp8(
        x_fp4.data_ptr(), scales.data_ptr(), scales.stride(0), scales.stride(1),
        fp8.data_ptr(), eb.data_ptr(), m, n, _stream(x_fp4))
    _build.check(err, "mxfp4_transpose_mxfp8")
    dispatch.note_launch("mxfp4_transpose_mxfp8")
    return fp8, eb
