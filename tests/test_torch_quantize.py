"""The port's quantizers (plain versions of kernels K1 and K2, reached
through the public ops on CPU tensors) against the JAX package and the
fp64 golden model.

Tolerances: scale bytes exact; e2m1 code mismatch rate <= 1e-4 (the
reference's tie-break budget, docs/PARITY.md); int8 operand and row
scale equal wherever the codes agree.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import qutlass_tpu as q
import qutlass_tpu_torch as qt
from qutlass_tpu.formats import golden as G
from qutlass_tpu_torch.ops import dispatch
from torch_helpers import hadamard_np, randn_bf16, to_torch

CODE_BUDGET = 1e-4


def _inputs(rot, seed=0, shape=(2, 96, 512)):
    rng = np.random.default_rng(seed)
    return randn_bf16(rng, *shape), hadamard_np(rot)


def _codes_mismatch(a, b) -> float:
    return float((np.asarray(a) != np.asarray(b)).mean())


@pytest.mark.parametrize("layout", ["rowmajor", "kmajor", "kmajor_codes"])
@pytest.mark.parametrize("rot", [16, 32, 64, 128])
@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_fused_quantize_mx_matches_jax_and_golden(method, rot, layout):
    x, h = _inputs(rot)
    mask = method == "quest"
    want = q.fusedQuantizeMx(jnp.asarray(x), jnp.asarray(h), method=method,
                             return_mask=mask, layout=layout)
    got = qt.fusedQuantizeMx(to_torch(x), to_torch(h), method=method,
                             return_mask=mask, layout=layout)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert tuple(g.shape) == np.asarray(w).shape and g.dtype == torch.uint8
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert _codes_mismatch(got[0].numpy(), want[0]) <= CODE_BUDGET
    if mask:
        assert _codes_mismatch(got[2].numpy(), want[2]) <= CODE_BUDGET
    # scale bytes equal the fp64 golden exactly
    rows, k = x.size // x.shape[-1], x.shape[-1]
    ref = G.quantize_mx(x.astype(np.float64).reshape(rows, k),
                        h.astype(np.float64), rot, method)
    sb = got[1].numpy()
    sb = sb[:rows, :k // 32] if layout == "rowmajor" else sb.T
    np.testing.assert_array_equal(sb, ref["e8m0"])


def _binades(x, rng):
    """x with every 32-group scaled by 2^U(-12, 3): a row's groups span
    more than 3 binades, so its deficit is > 3 and a' rounds."""
    e = np.exp2(rng.integers(-12, 4, (x.shape[0], x.shape[1] // 32))).repeat(32, axis=1)
    return (x.astype(np.float32) * e).astype(x.dtype)


# the existing (80, 1024) inputs at every rotation, then the rows and K at
# which the Hopper kernels K2 / K6 split their grid (rows 1, 4 and 13 in
# one row tile; K = 160 ends in a ragged 32-column chunk), and rows whose
# deficit is > 3
INT8_CASES = ([pytest.param(rot, (80, 1024), "randn", id=str(rot)) for rot in (16, 32, 64, 128)]
              + [pytest.param(rot, (rows, k), data, id=f"{rot}-{rows}x{k}-{data}")
                 for rot, (rows, k), data in
                 [(32, (rows, k), "randn") for rows in (1, 4, 13) for k in (96, 160, 4096)]
                 + [(32, (13, 4096), "binades"), (16, (4, 160), "binades")]])


@pytest.mark.parametrize("rot,shape,data", INT8_CASES)
@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_fused_quantize_mx_int8_matches_jax(method, rot, shape, data):
    x, h = _inputs(rot, seed=1, shape=shape)
    if data == "binades":
        x = _binades(x, np.random.default_rng(3))
    wa, ws, wb = q.fusedQuantizeMxInt8(jnp.asarray(x), jnp.asarray(h),
                                       method=method)
    ga, gs, gb = qt.fusedQuantizeMxInt8(to_torch(x), to_torch(h), method=method)
    assert (ga.dtype, gs.dtype, gb.dtype) == (torch.int8, torch.float32, torch.uint8)
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    # a' agrees wherever the codes agree: compare against the composed
    # kmajor-codes quantize of each package
    wc, _ = q.fusedQuantizeMx(jnp.asarray(x), jnp.asarray(h), method=method,
                              layout="kmajor_codes")
    gc, _ = qt.fusedQuantizeMx(to_torch(x), to_torch(h), method=method,
                               layout="kmajor_codes")
    same = gc.numpy() == np.asarray(wc)
    assert 1 - same.mean() <= CODE_BUDGET
    np.testing.assert_array_equal(ga.numpy()[same], np.asarray(wa)[same])


def test_int8_activation_with_large_deficit_rounds_like_jax():
    """A row whose groups span many binades (deficit > 3) takes the
    rounded a' = rtne(m2 * 2^(3-d)) branch, as the JAX op does."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 512)) * np.exp2(rng.integers(-12, 4, (8, 16))
                                               ).repeat(32, axis=1)
    x = x.astype(np.float32).astype(randn_bf16(rng, 1).dtype)
    h = hadamard_np(32)
    wa, ws, _ = q.fusedQuantizeMxInt8(jnp.asarray(x), jnp.asarray(h))
    ga, gs, _ = qt.fusedQuantizeMxInt8(to_torch(x), to_torch(h))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


def test_cpu_tensors_take_the_plain_version():
    dispatch.reset_launch_counts()
    x, h = _inputs(32, shape=(4, 256))
    qt.fusedQuantizeMx(to_torch(x), to_torch(h))
    qt.fusedQuantizeMxInt8(to_torch(x), to_torch(h))
    assert all(v == 0 for v in dispatch.launch_counts.values())


@pytest.mark.parametrize("bad", ["dtype", "rot_size", "k_div", "method",
                                 "layout", "mask_absmax"])
def test_validation_errors(bad):
    x = torch.zeros((4, 256), dtype=torch.bfloat16)
    h = qt.hadamard_matrix(32, device="cpu")
    kw = {}
    if bad == "dtype":
        x = x.float()
    elif bad == "rot_size":
        h = qt.hadamard_matrix(8, device="cpu")
    elif bad == "k_div":
        x, h = (torch.zeros((4, 96), dtype=torch.bfloat16),
                qt.hadamard_matrix(64, device="cpu"))
    elif bad == "method":
        kw = {"method": "absmax"}
    elif bad == "layout":
        kw = {"layout": "colmajor"}
    else:
        kw = {"method": "abs_max", "return_mask": True}
    with pytest.raises((TypeError, ValueError)):
        qt.fusedQuantizeMx(x, h, **kw)


def test_mixed_devices_raise():
    with pytest.raises(ValueError):
        dispatch.on_cuda(torch.zeros(1), torch.zeros(1, device="meta"))
