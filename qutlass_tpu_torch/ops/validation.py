"""Argument validation for the public ops (PyTorch counterpart of
``qutlass_tpu.ops.validation``): dtype and shape checks that raise
descriptive errors before any kernel sees the tensors."""
from __future__ import annotations

import torch


def check_bf16(name: str, x: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bfloat16, got {x.dtype}")


def check_rotation(h: torch.Tensor, k: int) -> int:
    rot = h.shape[-1]
    if h.ndim != 2 or h.shape[0] != rot:
        raise ValueError(f"rotation must be square, got {tuple(h.shape)}")
    if rot not in (16, 32, 64, 128):
        raise ValueError(f"rotation size must be in (16, 32, 64, 128), "
                         f"got {rot}")
    if k % rot != 0:
        raise ValueError(f"last dim {k} must be divisible by the rotation "
                         f"size {rot}")
    return rot


def check_group_dim(name: str, k: int, gs: int) -> None:
    if k % gs != 0:
        raise ValueError(f"{name}: K={k} must be divisible by the "
                         f"quantization group size {gs}")
    if k < gs:
        raise ValueError(f"{name}: K={k} must be >= group size {gs}")


def check_global_scale(global_scale, device) -> torch.Tensor:
    """An NVFP4 global scale (a number, a 0-dim or a 1-element tensor) ->
    0-dim fp32 tensor on ``device``."""
    gs = torch.as_tensor(global_scale, dtype=torch.float32, device=device)
    if gs.numel() != 1:
        raise ValueError(f"global_scale must hold one value, got shape "
                         f"{tuple(gs.shape)}")
    return gs.reshape(())


def check_matmul_tn(a: torch.Tensor, b: torch.Tensor, gs: int):
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"operands must be 2-D, got {tuple(a.shape)} / "
                         f"{tuple(b.shape)}")
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"TN operands must share packed K: {tuple(a.shape)} "
                         f"vs {tuple(b.shape)}")
    k = a.shape[1] * 2
    check_group_dim("matmul", k, gs)
    return a.shape[0], b.shape[0], k


def check_tiles_32(name: str, m: int, n: int) -> None:
    """The QAT backward ops quantize 32x32 tiles or 32-groups along both
    axes of their [M, N] operand (M after the ops' own row padding)."""
    if m % 32 or n % 32:
        raise ValueError(f"{name}: M={m} and N={n} must be multiples of 32")


def check_matmul_fp8(a: torch.Tensor, b: torch.Tensor, k_axis: int) -> int:
    """MXFP8 GEMM operands: 2-D, a's axis ``k_axis`` and b's last axis
    the shared K, a multiple of the group 32.  Returns K."""
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"operands must be 2-D, got {tuple(a.shape)} / {tuple(b.shape)}")
    k = a.shape[k_axis]
    if b.shape[1] != k:
        raise ValueError(f"operands must share K={k}, got b {tuple(b.shape)}")
    check_group_dim("matmul_mxf8", k, 32)
    return k


def check_backward_rows(name: str, shape, h: torch.Tensor) -> None:
    """The QAT backward quantizers of [..., R, C] rotate along R and
    quantize it in 32-groups: R a multiple of 32 and of the rotation
    size."""
    if len(shape) < 2:
        raise ValueError(f"{name}: operand must be [..., rows, cols], got {tuple(shape)}")
    r = shape[-2]
    rot = check_rotation(h, r)
    if r % 32:
        raise ValueError(f"{name}: the rotated axis ({r}) must be a multiple of 32 "
                         f"(rotation size {rot})")


def check_kmajor_mx(name: str, qt: torch.Tensor, st: torch.Tensor) -> None:
    """A K-major MXFP4 operand: packed [K/2, rows] and e8m0 [K/32, rows],
    K a multiple of 32."""
    _check_kmajor(name, qt, st, 32)


def check_kmajor_nv(name: str, qt: torch.Tensor, st: torch.Tensor) -> None:
    """A K-major NVFP4 operand: packed [K/2, rows] and e4m3 [K/16, rows],
    K a multiple of 16."""
    _check_kmajor(name, qt, st, 16)


def _check_kmajor(name: str, qt: torch.Tensor, st: torch.Tensor, gs: int) -> None:
    if qt.ndim != 2 or st.ndim != 2:
        raise ValueError(f"{name}: operands must be 2-D, got {tuple(qt.shape)} / "
                         f"{tuple(st.shape)}")
    k, rows = qt.shape[0] * 2, qt.shape[1]
    check_group_dim(name, k, gs)
    if tuple(st.shape) != (k // gs, rows):
        raise ValueError(f"{name}: scales {tuple(st.shape)} do not match [{k // gs}, {rows}]")


def check_fused_linear(name: str, x: torch.Tensor, h: torch.Tensor, wqt: torch.Tensor,
                       wst: torch.Tensor, gs: int) -> int:
    """The single-kernel linear: x bf16 [..., K], a rotation that divides
    K, and a K-major weight (packed [K/2, N], scales [K/gs, N]) of the same
    K.  Returns the rotation size."""
    check_bf16("x", x)
    k = x.shape[-1]
    rot = check_rotation(h, k)
    _check_kmajor(name, wqt, wst, gs)
    if wqt.shape[0] * 2 != k:
        raise ValueError(f"{name}: the weight's K ({wqt.shape[0] * 2}) differs from x's ({k})")
    return rot
