"""Shared utilities of the PyTorch-port tests: data moves between the two
packages as numpy arrays, bf16 through its bit pattern.  ``ml_dtypes`` is
imported only where a bf16 array is made: the card's tests import this
module for ``nan_equal`` and the operand builders alone.

Imported in a pytest-xdist worker, it gives the worker's torch its share of
the cores, ``os.cpu_count() // PYTEST_XDIST_WORKER_COUNT`` intra-op threads
(at least one): each worker otherwise keeps torch's default of one thread
a core, and the workers' threads then outnumber the cores and spend the
run switching.  Every port test file imports this module, so a lone ``-n``
run of one file takes the same budget."""
import os

import numpy as np
import torch

from qutlass_tpu_torch.models.convert import tensor_from_numpy

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if WORKERS:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // WORKERS))


def to_torch(a, device="cpu") -> torch.Tensor:
    """numpy / JAX array -> tensor on ``device`` (the CPU unless named),
    bit-exact (bf16 included)."""
    return tensor_from_numpy(np.array(a), device)


def to_np(t: torch.Tensor) -> np.ndarray:
    """tensor -> numpy, bit-exact (bf16 comes back as ml_dtypes.bfloat16)."""
    import ml_dtypes
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def hadamard_np(n: int) -> np.ndarray:
    """Normalized Sylvester-Hadamard matrix in bf16 (numpy)."""
    import ml_dtypes
    h = np.array([[1.0]])
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return (h * n ** -0.5).astype(ml_dtypes.bfloat16)


def randn_bf16(rng: np.random.Generator, *shape, scale=25.0) -> np.ndarray:
    import ml_dtypes
    return (rng.standard_normal(shape) * scale).astype(ml_dtypes.bfloat16)


def cosine(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def nan_equal(got: torch.Tensor, want: torch.Tensor) -> bool:
    """The same NaN positions, and the same bits everywhere else."""
    gn, wn = torch.isnan(got.float()), torch.isnan(want.float())
    return bool(torch.equal(gn, wn)) and bool(torch.equal(got[~gn], want[~wn]))


def nv_adversarial(m: int, n: int, k: int, seed: int, special: bool):
    """K-major NVFP4 operands (codes [K/2, M], [K/2, N], scale bytes
    [K/16, M], [K/16, N], CPU tensors) whose fp64 sums round: the first
    groups add the largest term (6 * 6 * 16 * 448 * 448, every output
    alike) until the sum passes 2^33, the last as many subtract it again,
    and the 16 groups between add terms of random codes and scale bytes of
    either sign with exponent fields 0..2 (multiples of 2^-20, terms ~47
    binades below the largest), under the ulp of the running sum.
    ``special`` plants NaN (0x7F, 0xFF) and zero (0x00, 0x80) scale bytes."""
    rng = np.random.default_rng(seed)
    groups = k // 16
    nb = (groups - 16) // 2
    at = rng.integers(0, 256, (k // 2, m), dtype=np.uint8)
    bt = rng.integers(0, 256, (k // 2, n), dtype=np.uint8)
    at[:8 * nb], bt[:8 * nb], bt[8 * (groups - nb):], at[8 * (groups - nb):] = 0x77, 0x77, 0x77, 0xFF
    ast, bst = ((rng.integers(0, 256, (groups, r), dtype=np.uint8) & 0x87)
                | (rng.integers(0, 3, (groups, r), dtype=np.uint8) << 3) for r in (m, n))
    for s in (ast, bst):
        s[:nb], s[groups - nb:] = 0x7E, 0x7E
    if special:
        ast[nb + 1, 1], bst[nb + 2, 3], bst[groups - 1, n - 1], ast[0, m - 1] = 0x7F, 0xFF, 0x7F, 0xFF
        ast[nb + 3, :], bst[:, 2], bst[nb + 4, 5], ast[:, 4] = 0, 0, 0x80, 0
    return tuple(torch.from_numpy(t) for t in (at, bt, ast, bst))


def mx_adversarial(m: int, n: int, k: int, seed: int, special: bool):
    """K-major MXFP4 operands (codes [K/2, M], [K/2, N], scale bytes
    [K/32, M], [K/32, N], CPU tensors) whose fp64 sums round: the first
    groups add the largest term (6 * 6 * 32 * 2^40, scale bytes 147, every
    output alike) until the sum passes 2^55, the last as many subtract it
    again, and the 16 groups between add terms of random codes and scale
    bytes 125..128 (2^-4 to 2^2 times p), near the ulp of the running sum
    (8), so that they round there.  ``special`` plants NaN scale bytes
    (255).  Needs K >= 512."""
    rng = np.random.default_rng(seed)
    groups = k // 32
    nb = (groups - 16) // 2
    at = rng.integers(0, 256, (k // 2, m), dtype=np.uint8)
    bt = rng.integers(0, 256, (k // 2, n), dtype=np.uint8)
    at[:16 * nb], bt[:16 * nb], bt[16 * (groups - nb):], at[16 * (groups - nb):] = 0x77, 0x77, 0x77, 0xFF
    ast, bst = (rng.integers(125, 129, (groups, r), dtype=np.uint8) for r in (m, n))
    for s in (ast, bst):
        s[:nb], s[groups - nb:] = 147, 147
    if special:
        ast[nb + 1, 1], bst[nb + 2, 3], bst[groups - 1, n - 1], ast[0, m - 1] = 255, 255, 255, 255
    return tuple(torch.from_numpy(t) for t in (at, bt, ast, bst))


def mx_spread(m: int, n: int, k: int, seed: int, a_bytes=(104, 131), b_bytes=(126, 130)):
    """K-major MXFP4 operands (as ``mx_adversarial``) of random codes whose
    group scales spread over ~29 binades (a's bytes in [104, 131), b's in
    [126, 130)): an fp32 chain over K rounds (24 bits), while the fp64 sum
    of the exact group terms stays exact up to K = 12288 (29 binades + 13
    bits of a group sum + 9 bits of 384 groups < 53)."""
    rng = np.random.default_rng(seed)
    at = rng.integers(0, 256, (k // 2, m), dtype=np.uint8)
    bt = rng.integers(0, 256, (k // 2, n), dtype=np.uint8)
    ast = rng.integers(*a_bytes, (k // 32, m), dtype=np.uint8)
    bst = rng.integers(*b_bytes, (k // 32, n), dtype=np.uint8)
    return tuple(torch.from_numpy(t) for t in (at, bt, ast, bst))


# Groups of bf16 values whose fp32 QuEST sums round to a different scale
# byte in the xor butterfly order and from left to right (found by a
# seeded search over groups with elements spread over 12 binades): under
# the identity rotation the rotated values are the inputs, so the group's
# scale byte shows which order a quantizer summed in.
NV_ORDER_GROUP = [
    7.581710815429688e-05, -0.00250244140625, -10.25, 10.3125, -30.125, -9.1875,
    2.453125, -44.5, 28.375, 0.10888671875, -16.25, -0.080078125, 0.1982421875,
    0.0118408203125, -15.375, -0.03369140625]
MX_ORDER_GROUP = [
    -0.00518798828125, 3.734375, -0.337890625, 68.0, 62.25, -0.0181884765625,
    -0.111328125, 55.75, -0.0091552734375, 2.96875, 0.004058837890625,
    0.357421875, 0.062255859375, 55.0, -0.0194091796875, 3.375, -0.052978515625,
    1.4453125, -0.016845703125, -67.5, 0.0169677734375, 59.25, 0.6484375, -59.0,
    -9.125, -0.1123046875, 16.25, -91.0, -0.71484375, -0.002227783203125,
    0.318359375, -0.7109375]
