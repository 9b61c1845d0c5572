"""Layout helpers (PyTorch counterpart of ``qutlass_tpu.utils``).

Block scales travel as plain row-major ``[rows, K/32]`` (or K-major
``[K/32, rows]``) bytes; ``to_blocked`` is a flatten kept for API parity
with the reference (qutlass/utils.py:160-193).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return ceil_div(a, b) * b


def get_padded_shape_mx(a: torch.Tensor) -> tuple[int, int]:
    """Padded e8m0 scale-buffer shape of an MX quantize of ``a``: rows to
    a multiple of 128, K/32 columns to a multiple of 4 (reference
    utils.py:140-147)."""
    return round_up(a.numel() // a.shape[-1], 128), round_up(a.shape[-1] // 32, 4)


def get_padded_shape_nv(a: torch.Tensor) -> tuple[int, int]:
    """Padded e4m3 scale-buffer shape of an NV quantize of ``a`` (K/16
    columns)."""
    return round_up(a.numel() // a.shape[-1], 128), round_up(a.shape[-1] // 16, 4)


def to_blocked(scales: torch.Tensor, use_triton_kernel: bool = False) -> torch.Tensor:
    """Scale layout transform: a flatten of the (already padded) scale
    matrix.  ``use_triton_kernel`` is accepted for signature parity and
    ignored."""
    del use_triton_kernel
    return scales.reshape(-1)


def from_blocked(flat: torch.Tensor, k: int, gs: int) -> torch.Tensor:
    """Inverse of :func:`to_blocked`: recover the padded 2-D scale matrix."""
    return flat.reshape(-1, round_up(k // gs, 4))


def to_blocked_swizzled(scales: torch.Tensor) -> torch.Tensor:
    """The cuBLAS 128x4 block-swizzled scale layout of a padded [H, W]
    matrix (H a multiple of 128, W of 4), flattened, for export to other
    GPU stacks (reference utils.py:160-193)."""
    rows, cols = scales.shape
    if rows % 128 or cols % 4:
        raise ValueError(f"pad the scales to [x128, x4] first, got {tuple(scales.shape)}")
    b = scales.reshape(rows // 128, 128, cols // 4, 4).permute(0, 2, 1, 3)
    return b.reshape(-1, 4, 32, 4).permute(0, 2, 1, 3).reshape(-1)


def pad_to_block(x: torch.Tensor, dims, blocksize: int) -> torch.Tensor:
    """Zero-pad ``dims`` of ``x`` up to a multiple of ``blocksize``."""
    pads = [0] * (2 * x.ndim)
    for d in dims:
        d = d % x.ndim
        # F.pad lists pads from the last dim backwards: (left, right) pairs
        pads[2 * (x.ndim - 1 - d) + 1] = round_up(x.shape[d], blocksize) - x.shape[d]
    if not any(pads):
        return x
    return F.pad(x, pads)


def default_device() -> torch.device:
    """The device of the port's entry points when the caller names none:
    the CUDA card.  There is no fallback: without a card such a call
    fails, and a caller who wants the CPU asks for it."""
    return torch.device("cuda")


def resolve_device(device) -> torch.device:
    """``device``, or :func:`default_device` when it is None."""
    return default_device() if device is None else torch.device(device)


def hadamard_matrix(n: int, dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """Normalized Sylvester-Hadamard rotation ``H_n / sqrt(n)`` (on the
    card unless ``device`` says otherwise)."""
    if n < 1 or n & (n - 1):
        raise ValueError(f"Hadamard size must be a power of 2, got {n}")
    h = np.array([[1.0]])
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return torch.tensor(h * n ** -0.5, dtype=dtype, device=resolve_device(device))


def dct_matrix(n: int, dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """Orthonormal DCT-II rotation: row i, column j is ``c_i * cos(pi *
    (2j + 1) * i / (2n))`` with ``c_0 = sqrt(1/n)``, ``c_i = sqrt(2/n)``
    (computed in fp64, on the card unless ``device`` says otherwise)."""
    i = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    m = np.cos(np.pi * (2 * j + 1) * i / (2 * n))
    m[0] *= np.sqrt(1.0 / n)
    m[1:] *= np.sqrt(2.0 / n)
    return torch.tensor(m, dtype=dtype, device=resolve_device(device))


def identity_matrix(n: int, dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """Identity "rotation" (quantize without rotating), on the card unless
    ``device`` says otherwise."""
    return torch.eye(n, dtype=dtype, device=resolve_device(device))


def h128(h: torch.Tensor, rot_size: int) -> torch.Tensor:
    """The [rot, rot] rotation lifted to the 128x128 block-diagonal
    kron(I, H) in bf16, on h's device."""
    reps = 128 // rot_size
    hb = h.to(torch.bfloat16)
    if reps == 1:
        return hb
    return torch.kron(torch.eye(reps, dtype=torch.bfloat16, device=h.device), hb)
