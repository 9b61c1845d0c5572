"""Wrappers of the quantize kernels K1 (``csrc/quantize_mx.cu``), K2
(``csrc/quantize_mx_int8.cu``), K5 (``csrc/quantize_nv.cu``) and K6
(``csrc/quantize_nv_int8.cu``).

Each wrapper routes by device: tensors on the CPU go to the kernel's
plain version (``*_plain``, defined in ``ops.emulation``), tensors on a
CUDA device to the kernel, which launches on the current stream into
outputs allocated here.  A launch adds one to
``dispatch.launch_counts``.  The NV kernels read the global scale from
device memory, so a scale computed on the card needs no host sync.

K2 and K6 take the row maximum across blocks in an int32 scratch
[rows + 1] that holds zeros on entry and that each call leaves zero (the
last block of its encode launch resets it).  It is kept per (device,
stream) and zeroed once, as K3's counters are, so a call is two
launches, syncs nothing and replays in a CUDA graph.
"""
from __future__ import annotations

import torch

from ..ops import dispatch
from ..ops import validation as _val
from ..ops.emulation import fused_quantize_mx as quantize_mx_plain
from ..ops.emulation import fused_quantize_mx_int8 as quantize_mx_int8_plain
from ..ops.emulation import fused_quantize_nv as quantize_nv_plain
from ..ops.emulation import fused_quantize_nv_int8 as quantize_nv_int8_plain
from ..utils import round_up
from . import _build

_LAYOUTS = {"rowmajor": 0, "kmajor": 1, "kmajor_codes": 2}
_scratch: dict[tuple[int, int], torch.Tensor] = {}
_retired: list[torch.Tensor] = []   # outgrown scratch a captured graph may still use
_METHODS = {"quest": 0, "abs_max": 1}


def _check(a: torch.Tensor, h: torch.Tensor, rot_size: int, method: str,
           group: int = 32):
    """Validate a CUDA call; return (x [rows, K] contiguous, h bf16)."""
    _val.check_bf16("a", a)
    if method not in _METHODS:
        raise ValueError(f"invalid method {method!r}")
    if _val.check_rotation(h, a.shape[-1]) != rot_size:
        raise ValueError(f"rotation is {tuple(h.shape)}, rot_size {rot_size}")
    _val.check_group_dim("quantize", a.shape[-1], group)
    if not a.is_contiguous():
        raise ValueError("a must be contiguous")
    return a.reshape(-1, a.shape[-1]), h.to(torch.bfloat16).contiguous()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _int8_scratch(dev: torch.device, rows: int) -> torch.Tensor:
    """K2's / K6's zeroed int32 scratch (at least ``rows + 1``) for the
    current stream of ``dev``; a larger one replaces it when ``rows``
    outgrows it, and the old one stays allocated."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < rows + 1:
        if buf is not None:
            _retired.append(buf)
        buf = _scratch[key] = torch.zeros(max(rows + 1, 1024), dtype=torch.int32, device=dev)
    return buf


def quantize_mx(a: torch.Tensor, h: torch.Tensor, *, rot_size: int,
                method: str = "quest", return_mask: bool = False,
                layout: str = "rowmajor"):
    """Kernel K1: rotate + MXFP4 quantize.  Same contract as
    :func:`quantize_mx_plain` (``ops.emulation.fused_quantize_mx``)."""
    if not dispatch.on_cuda(a, h):
        return quantize_mx_plain(a, h, rot_size=rot_size, method=method,
                                 return_mask=return_mask, layout=layout)
    if layout not in _LAYOUTS:
        raise ValueError(f"invalid layout {layout!r}")
    x, hb = _check(a, h, rot_size, method)
    rows, k = x.shape
    u8 = dict(dtype=torch.uint8, device=a.device)
    if layout == "rowmajor":
        q = torch.empty((rows, k // 2), **u8)
        s = torch.zeros((round_up(rows, 128), round_up(k // 32, 4)), **u8)
        s_sg, s_sr = 1, s.shape[1]
        mask = torch.empty((rows, k // 8), **u8) if return_mask else None
        m_sj, m_sr = 1, k // 8
    else:
        q = torch.empty((k, rows) if layout == "kmajor_codes" else (k // 2, rows),
                        **u8)
        s = torch.empty((k // 32, rows), **u8)
        s_sg, s_sr = rows, 1
        mask = torch.empty((k // 8, rows), **u8) if return_mask else None
        m_sj, m_sr = rows, 1
    err = _build.library().qt_quantize_mx(
        x.data_ptr(), hb.data_ptr(), q.data_ptr(), s.data_ptr(),
        mask.data_ptr() if mask is not None else None, rows, k, rot_size,
        _METHODS[method], _LAYOUTS[layout], s_sg, s_sr, m_sj, m_sr, _stream(a))
    _build.check(err, "quantize_mx")
    dispatch.note_launch("quantize_mx")
    if layout == "rowmajor":
        q = q.reshape(*a.shape[:-1], k // 2)
        if mask is not None:
            mask = mask.reshape(*a.shape[:-1], k // 8)
    return (q, s, mask) if return_mask else (q, s)


def quantize_mx_int8(a: torch.Tensor, h: torch.Tensor, *, rot_size: int,
                     method: str = "quest"):
    """Kernel K2: rotate + MXFP4 quantize + int8 encode.  Returns (a'
    int8 [K, rows], row scale f32 [rows], scale bytes u8 [K/32, rows]),
    the contract of :func:`quantize_mx_int8_plain`."""
    if not dispatch.on_cuda(a, h):
        return quantize_mx_int8_plain(a, h, rot_size=rot_size, method=method)
    x, hb = _check(a, h, rot_size, method)
    rows, k = x.shape
    ai = torch.empty((k, rows), dtype=torch.int8, device=a.device)
    sa = torch.empty((rows,), dtype=torch.float32, device=a.device)
    s = torch.empty((k // 32, rows), dtype=torch.uint8, device=a.device)
    err = _build.library().qt_quantize_mx_int8(
        x.data_ptr(), hb.data_ptr(), ai.data_ptr(), sa.data_ptr(), s.data_ptr(),
        _int8_scratch(a.device, rows).data_ptr(), rows, k, rot_size, _METHODS[method],
        _stream(a))
    _build.check(err, "quantize_mx_int8")
    dispatch.note_launch("quantize_mx_int8")
    return ai, sa, s


def quantize_nv(a: torch.Tensor, h: torch.Tensor, global_scale, *,
                rot_size: int, method: str = "abs_max",
                layout: str = "rowmajor"):
    """Kernel K5: rotate + NVFP4 quantize (group 16, e4m3 scales).  Same
    contract as :func:`quantize_nv_plain` (``ops.emulation.fused_quantize_nv``)."""
    gs = _val.check_global_scale(global_scale, a.device)
    if not dispatch.on_cuda(a, h, gs):
        return quantize_nv_plain(a, h, gs, rot_size=rot_size, method=method,
                                 layout=layout)
    if layout not in ("rowmajor", "kmajor"):
        raise ValueError(f"invalid layout {layout!r}")
    x, hb = _check(a, h, rot_size, method, group=16)
    rows, k = x.shape
    u8 = dict(dtype=torch.uint8, device=a.device)
    if layout == "rowmajor":
        q = torch.empty((rows, k // 2), **u8)
        s = torch.zeros((round_up(rows, 128), round_up(k // 16, 4)), **u8)
        s_sg, s_sr = 1, s.shape[1]
    else:
        q = torch.empty((k // 2, rows), **u8)
        s = torch.empty((k // 16, rows), **u8)
        s_sg, s_sr = rows, 1
    err = _build.library().qt_quantize_nv(
        x.data_ptr(), hb.data_ptr(), gs.data_ptr(), q.data_ptr(), s.data_ptr(),
        rows, k, rot_size, _METHODS[method], int(layout == "kmajor"), s_sg, s_sr,
        _stream(a))
    _build.check(err, "quantize_nv")
    dispatch.note_launch("quantize_nv")
    if layout == "rowmajor":
        q = q.reshape(*a.shape[:-1], k // 2)
    return q, s


def quantize_nv_int8(a: torch.Tensor, h: torch.Tensor, global_scale, *,
                     rot_size: int, method: str = "abs_max"):
    """Kernel K6: rotate + NVFP4 quantize + int8 encode.  Returns (a'
    int8 [K, rows], sigma f32 [rows], e4m3 bytes u8 [K/16, rows]), the
    contract of :func:`quantize_nv_int8_plain`."""
    gs = _val.check_global_scale(global_scale, a.device)
    if not dispatch.on_cuda(a, h, gs):
        return quantize_nv_int8_plain(a, h, gs, rot_size=rot_size, method=method)
    x, hb = _check(a, h, rot_size, method, group=16)
    rows, k = x.shape
    ai = torch.empty((k, rows), dtype=torch.int8, device=a.device)
    sigma = torch.empty((rows,), dtype=torch.float32, device=a.device)
    s = torch.empty((k // 16, rows), dtype=torch.uint8, device=a.device)
    err = _build.library().qt_quantize_nv_int8(
        x.data_ptr(), hb.data_ptr(), gs.data_ptr(), ai.data_ptr(),
        sigma.data_ptr(), s.data_ptr(), _int8_scratch(a.device, rows).data_ptr(), rows, k,
        rot_size, _METHODS[method], _stream(a))
    _build.check(err, "quantize_nv_int8")
    dispatch.note_launch("quantize_nv_int8")
    return ai, sigma, s
