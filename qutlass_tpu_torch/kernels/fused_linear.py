"""Wrappers of the single-kernel quantized linears K16 and K17
(``csrc/fused_linear.cu``).

Each wrapper routes by device: tensors on the CPU go to the kernel's
plain version (``*_plain``, in ``ops.emulation``), tensors on a CUDA
device to the kernel.  The weight is passed as its logical [N, K/2] view
with strides, so the K-major layout of ``fusedQuantize*(...,
layout="kmajor")`` needs no copy.  alpha and the NV global scale stay on
the card (the kernels read them from device memory).  The wrappers
validate their inputs on either device, for the public ops too.  A
launch adds one to ``dispatch.launch_counts``; a call the kernel cannot
take raises.
"""
from __future__ import annotations

import torch

from ..ops import dispatch
from ..ops import validation as _val
from ..ops.emulation import fused_linear_mxf4_plain as fused_linear_mx_plain
from ..ops.emulation import fused_linear_nvf4_plain as fused_linear_nv_plain
from . import _build

_METHODS = {"quest": 0, "abs_max": 1}


def _check(name: str, x, wqt, wst, h, rot_size: int, method: str, gs: int) -> None:
    """Validate a call on either device: the public ``fused_linear_*``
    leave the single-kernel route's checks to this layer."""
    if method not in _METHODS:
        raise ValueError(f"invalid method {method!r}")
    if x.ndim != 2:
        raise ValueError(f"{name}: x must be [M, K], got {tuple(x.shape)}")
    for t_name, t in (("wqt", wqt), ("wst", wst)):
        if t.dtype != torch.uint8:
            raise TypeError(f"{name}: {t_name} must be uint8, got {t.dtype}")
    if _val.check_fused_linear(name, x, h, wqt, wst, gs) != rot_size:
        raise ValueError(f"{name}: rotation is {tuple(h.shape)}, rot_size {rot_size}")


def _launch_args(name: str, x, h):
    """A CUDA call's x, checked contiguous, and h as contiguous bf16."""
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    return h.to(torch.bfloat16).contiguous()


def _scalar(v, device) -> torch.Tensor:
    """alpha as a 0-dim fp32 tensor on ``device``; a number is filled in
    there by a kernel, not copied from the host."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), v, dtype=torch.float32, device=device)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def fused_linear_mx(x: torch.Tensor, wqt: torch.Tensor, wst: torch.Tensor,
                    h: torch.Tensor, alpha, *, rot_size: int,
                    method: str = "quest") -> torch.Tensor:
    """Kernel K16: y [M, N] = bf16(dq(q(x H)) @ dq(w)^T * alpha), x bf16
    [M, K], the weight K-major MXFP4 (packed [K/2, N], e8m0 [K/32, N]);
    bitwise the composition of K1 (K-major) and K4.  ``alpha``: a number
    or a 1-element tensor, applied as given."""
    _check("fused_linear_mx", x, wqt, wst, h, rot_size, method, 32)
    al = _scalar(alpha, x.device)
    if not dispatch.on_cuda(x, wqt, wst, h, al):
        return fused_linear_mx_plain(x, wqt, wst, h, al, rot_size=rot_size, method=method)
    hb = _launch_args("fused_linear_mx", x, h)
    (m, k), n = x.shape, wqt.shape[1]
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m == 0 or n == 0:
        return y
    w_r, ws_r = wqt.T, wst.T                            # logical [N, K/2], [N, K/32]
    err = _build.library().qt_fused_linear_mx(
        x.data_ptr(), hb.data_ptr(), w_r.data_ptr(), w_r.stride(0), w_r.stride(1),
        ws_r.data_ptr(), ws_r.stride(0), ws_r.stride(1), al.data_ptr(), y.data_ptr(),
        m, n, k, rot_size, _METHODS[method], _stream(x))
    _build.check(err, "fused_linear_mx")
    dispatch.note_launch("fused_linear_mx")
    return y


def fused_linear_nv(x: torch.Tensor, wqt: torch.Tensor, wst: torch.Tensor,
                    h: torch.Tensor, global_scale, alpha, *, rot_size: int,
                    method: str = "abs_max") -> torch.Tensor:
    """Kernel K17: the NVFP4 twin of :func:`fused_linear_mx` (e4m3 [K/16,
    N] weight scales; x quantized under ``global_scale``); bitwise the
    composition of K5 (K-major) and K7."""
    _check("fused_linear_nv", x, wqt, wst, h, rot_size, method, 16)
    al = _scalar(alpha, x.device)
    gsv = _val.check_global_scale(global_scale, x.device)
    if not dispatch.on_cuda(x, wqt, wst, h, al, gsv):
        return fused_linear_nv_plain(x, wqt, wst, h, gsv, al, rot_size=rot_size,
                                     method=method)
    hb = _launch_args("fused_linear_nv", x, h)
    (m, k), n = x.shape, wqt.shape[1]
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m == 0 or n == 0:
        return y
    w_r, ws_r = wqt.T, wst.T                            # logical [N, K/2], [N, K/16]
    err = _build.library().qt_fused_linear_nv(
        x.data_ptr(), hb.data_ptr(), gsv.data_ptr(), w_r.data_ptr(), w_r.stride(0),
        w_r.stride(1), ws_r.data_ptr(), ws_r.stride(0), ws_r.stride(1), al.data_ptr(),
        y.data_ptr(), m, n, k, rot_size, _METHODS[method], _stream(x))
    _build.check(err, "fused_linear_nv")
    dispatch.note_launch("fused_linear_nv")
    return y
