"""Shared utilities of the PyTorch-port tests: data moves between the two
packages as numpy arrays, bf16 through its bit pattern."""
import numpy as np
import ml_dtypes
import torch

from qutlass_tpu_torch.models.convert import tensor_from_numpy


def to_torch(a, device="cpu") -> torch.Tensor:
    """numpy / JAX array -> tensor on ``device`` (the CPU unless named),
    bit-exact (bf16 included)."""
    return tensor_from_numpy(np.array(a), device)


def to_np(t: torch.Tensor) -> np.ndarray:
    """tensor -> numpy, bit-exact (bf16 comes back as ml_dtypes.bfloat16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def hadamard_np(n: int) -> np.ndarray:
    """Normalized Sylvester-Hadamard matrix in bf16 (numpy)."""
    h = np.array([[1.0]])
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return (h * n ** -0.5).astype(ml_dtypes.bfloat16)


def randn_bf16(rng: np.random.Generator, *shape, scale=25.0) -> np.ndarray:
    return (rng.standard_normal(shape) * scale).astype(ml_dtypes.bfloat16)


def cosine(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))
