"""The ordered plain versions of the fp4 quantizers,
``emulation.fused_quantize_mx_ordered_plain`` and
``fused_quantize_nv_ordered_plain``: the yardstick that the `gpu` tests
and ``chip_smoke.py`` hold kernels K1 and K5 to bit for bit.

They make two orders of fp32 sums explicit: each rotated value is one
chain ``v = f32(v + x[i] * h[i][c])`` over i = 0 .. rot-1, and each
group's QuEST sums are taken in the xor butterfly (offsets 16, 8, 4, 2, 1
for an MX 32-group; 8, 4, 2, 1 for an NV 16-group).

Tolerances: against a numpy model of the kernels' arithmetic (float32
chains and butterflies, ml_dtypes' e2m1 and e4m3 encoders): codes, scale
bytes and mask bytes bitwise.  Against the JAX package's
``fusedQuantizeMx`` / ``fusedQuantizeNv``, the budgets that
tests/test_torch_quantize.py and tests/test_torch_nvfp4.py hold the
public plain versions to: MX scale bytes exact, codes and mask bytes
within a 1e-4 mismatch rate; NV scale bytes and codes within 1e-4.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import qutlass_tpu as q
from qutlass_tpu_torch.ops import emulation as E
from torch_helpers import MX_ORDER_GROUP, NV_ORDER_GROUP, hadamard_np, randn_bf16, to_torch

BUDGET = 1e-4
QUEST = np.float32(2.92247856 / 6.0)
EPS = np.float32(1e-8)
# small ragged shapes: every rotation at (70, 640), the two that divide
# K = 160 at (33, 160), and the two wide ones at 9 rows of K = 384
CASES = ([(rot, (70, 640)) for rot in (16, 32, 64, 128)]
         + [(16, (33, 160)), (32, (33, 160)), (64, (9, 384)), (128, (9, 384))])
GS = 2.5   # an NV global scale


def _x(shape, seed=0):
    return randn_bf16(np.random.default_rng(seed), *shape)


# ---------------------------------------------------------------------------
# the numpy model of the kernels' arithmetic
# ---------------------------------------------------------------------------

def np_rotate(x, h, rot):
    """Each output one float32 chain over i in ascending order."""
    xr = np.asarray(x, np.float32).reshape(-1, rot)
    hh = np.asarray(h, np.float32)
    v = np.zeros_like(xr)
    for i in range(rot):
        v = (v + (xr[:, i:i + 1] * hh[i]).astype(np.float32)).astype(np.float32)
    return v.reshape(np.shape(x))


def np_butterfly(g):
    """The xor butterfly over the last axis, np.float32 adds."""
    n = g.shape[-1]
    idx = np.arange(n)
    o = n // 2
    while o:
        g = (g + g[..., idx ^ o]).astype(np.float32)
        o //= 2
    return g[..., 0]


def np_left_to_right(g):
    s = np.zeros(g.shape[:-1], np.float32)
    for i in range(g.shape[-1]):
        s = (s + g[..., i]).astype(np.float32)
    return s


def _quest_scale(s1, s2, n):
    mean = (s1 * np.float32(1.0 / n)).astype(np.float32)
    var = (s2 * np.float32(1.0 / n) - mean * mean).astype(np.float32)
    scale = (np.sqrt(np.maximum(var, np.float32(0))) * QUEST + EPS).astype(np.float32)
    return var, scale


def _e2m1(v):
    """e2m1 codes 0..15 (RTNE, saturating to +-6) by ml_dtypes."""
    return np.clip(v, -6, 6).astype(ml_dtypes.float4_e2m1fn).view(np.uint8) & 0xF


def _e4m3_bytes(v):
    return np.clip(v, -448, 448).astype(ml_dtypes.float8_e4m3fn).view(np.uint8)


def np_quantize_mx(x, h, rot, method, sums=np_butterfly):
    """-> (codes [rows, K], scale bytes [rows, K/32], clip mask bool [rows, K])."""
    k = x.shape[-1]
    g = np_rotate(x, h, rot).reshape(-1, k // 32, 32)
    if method == "quest":
        var, scale = _quest_scale(sums(g), sums((g * g).astype(np.float32)), 32)
        scale = np.where(var >= 0, scale, np.float32(1.0))
    else:
        scale = (np.abs(g).max(-1) + EPS).astype(np.float32)
    byte = (scale.view(np.int32) >> 23) & 0xFF
    qv = (g * np.ldexp(np.float32(1.0), 127 - byte)[..., None]).astype(np.float32)
    if method != "quest":
        qv = (qv * np.float32(3.0)).astype(np.float32)
    qv = qv.reshape(-1, k)
    return _e2m1(qv), byte.astype(np.uint8), np.abs(qv) < 6


def np_quantize_nv(x, h, rot, method, gs, sums=np_butterfly):
    """-> (codes [rows, K], e4m3 scale bytes [rows, K/16])."""
    k = x.shape[-1]
    g = np_rotate(x, h, rot).reshape(-1, k // 16, 16)
    gs = np.float32(gs)
    if method == "abs_max":
        amax = np.abs(g).max(-1)
        byte = _e4m3_bytes((gs * (amax * np.float32(1.0 / 6.0))).astype(np.float32))
        sf = byte.view(ml_dtypes.float8_e4m3fn).astype(np.float32)
        mul = np.where(sf != 0, gs / np.where(sf != 0, sf, 1), 0).astype(np.float32)
    else:
        var, scale = _quest_scale(sums(g), sums((g * g).astype(np.float32)), 16)
        byte = np.where(var >= 0, _e4m3_bytes(scale), np.uint8(0xFF)).astype(np.uint8)
        sf = byte.view(ml_dtypes.float8_e4m3fn).astype(np.float32)
        ok = (var >= 0) & (sf > 0)
        mul = np.where(ok, np.float32(1.0) / np.where(ok, sf, 1), 0).astype(np.float32)
    return _e2m1((g * mul[..., None]).astype(np.float32).reshape(-1, k)), byte


# ---------------------------------------------------------------------------
# the ordered plain versions' outputs as [rows, ...] arrays
# ---------------------------------------------------------------------------

def _codes(t, layout, rows, k):
    if layout == "rowmajor":
        return E.unpack_codes(t).reshape(rows, k).numpy()
    if layout == "kmajor":
        return E.unpack_codes(t.T).numpy()
    return t.T.numpy().astype(np.int32)


def _rows(t, layout, rows, cols):
    """Scale or mask bytes [rows, cols] from the layout's buffer."""
    return (t[:rows, :cols] if layout == "rowmajor" else t.T).numpy()


def _mask_bits(mask):
    """Unpacked mask bytes [rows, K/8] -> bool [rows, K]."""
    return np.unpackbits(mask, axis=-1, bitorder="little").astype(bool)


@pytest.mark.parametrize("layout", ["rowmajor", "kmajor", "kmajor_codes"])
@pytest.mark.parametrize("rot,shape", CASES)
@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_mx_ordered_plain_is_the_numpy_model(method, rot, shape, layout):
    """Codes, scale bytes and the clip mask bitwise the numpy model."""
    x, h = _x(shape), hadamard_np(rot)
    rows, k = shape
    codes, sb, mask = E.fused_quantize_mx_ordered_plain(
        to_torch(x), to_torch(h), rot_size=rot, method=method, return_mask=True,
        layout=layout)
    wc, wb, wm = np_quantize_mx(x, h, rot, method)
    np.testing.assert_array_equal(_codes(codes, layout, rows, k), wc)
    np.testing.assert_array_equal(_rows(sb, layout, rows, k // 32), wb)
    np.testing.assert_array_equal(_mask_bits(_rows(mask.reshape(-1, mask.shape[-1]), layout,
                                                   rows, k // 8)), wm)


@pytest.mark.parametrize("layout", ["rowmajor", "kmajor"])
@pytest.mark.parametrize("rot,shape", CASES)
@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_nv_ordered_plain_is_the_numpy_model(method, rot, shape, layout):
    """Codes and e4m3 scale bytes bitwise the numpy model."""
    x, h = _x(shape, seed=1), hadamard_np(rot)
    rows, k = shape
    codes, sb = E.fused_quantize_nv_ordered_plain(
        to_torch(x), to_torch(h), torch.tensor(GS), rot_size=rot, method=method,
        layout=layout)
    wc, wb = np_quantize_nv(x, h, rot, method, GS)
    np.testing.assert_array_equal(_codes(codes, layout, rows, k), wc)
    np.testing.assert_array_equal(_rows(sb, layout, rows, k // 16), wb)


@pytest.mark.parametrize("layout", ["rowmajor", "kmajor", "kmajor_codes"])
@pytest.mark.parametrize("rot,shape", CASES[:6])
@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_mx_ordered_plain_matches_jax(method, rot, shape, layout):
    """Within the JAX budgets of tests/test_torch_quantize.py: scale bytes
    exact, codes and mask bytes within a 1e-4 mismatch rate."""
    x, h = _x(shape, seed=2), hadamard_np(rot)
    mask = method == "quest"
    want = q.fusedQuantizeMx(jnp.asarray(x), jnp.asarray(h), method=method,
                             return_mask=mask, layout=layout)
    got = E.fused_quantize_mx_ordered_plain(to_torch(x), to_torch(h), rot_size=rot,
                                            method=method, return_mask=mask, layout=layout)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert tuple(g.shape) == np.asarray(w).shape and g.dtype == torch.uint8
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert (got[0].numpy() != np.asarray(want[0])).mean() <= BUDGET
    if mask:
        assert (got[2].numpy() != np.asarray(want[2])).mean() <= BUDGET


@pytest.mark.parametrize("layout", ["rowmajor", "kmajor"])
@pytest.mark.parametrize("rot,shape", CASES[:6])
@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_nv_ordered_plain_matches_jax(method, rot, shape, layout):
    """Within the JAX budgets of tests/test_torch_nvfp4.py: scale bytes and
    codes within a 1e-4 mismatch rate."""
    x, h = _x(shape, seed=3), hadamard_np(rot)
    want = q.fusedQuantizeNv(jnp.asarray(x), jnp.asarray(h), jnp.asarray([GS], jnp.float32),
                             method=method, layout=layout)
    got = E.fused_quantize_nv_ordered_plain(to_torch(x), to_torch(h), torch.tensor([GS]),
                                            rot_size=rot, method=method, layout=layout)
    for w, g in zip(want, got):
        assert tuple(g.shape) == np.asarray(w).shape and g.dtype == torch.uint8
    assert (got[1].numpy() != np.asarray(want[1])).mean() <= BUDGET
    assert (got[0].numpy() != np.asarray(want[0])).mean() <= BUDGET


@pytest.mark.parametrize("n", [16, 32])
def test_butterfly_sum_is_the_numpy_butterfly(n):
    g = np.asarray(_x((64, n), seed=4), np.float32) * np.exp2(
        np.random.default_rng(5).integers(-8, 9, (64, n))).astype(np.float32)
    got = E.butterfly_sum(torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), np_butterfly(g).view(np.int32))


def test_rotate_ordered_is_the_numpy_chain():
    x, h = _x((33, 256), seed=6), hadamard_np(128)
    got = E.rotate_ordered(to_torch(x), to_torch(h), 128).numpy()
    np.testing.assert_array_equal(got.view(np.int32), np_rotate(x, h, 128).view(np.int32))


@pytest.mark.parametrize("fmt", ["mx", "nv"])
def test_butterfly_and_left_to_right_sums_differ(fmt):
    """The two orders give different fp32 sums and a different QuEST scale
    byte on one group; the ordered plain version gives the butterfly's
    byte, so a quantizer that reordered the sum would fail the bitwise
    tests above and the kernels' `gpu` tests."""
    vals = MX_ORDER_GROUP if fmt == "mx" else NV_ORDER_GROUP
    n = len(vals)
    x = np.asarray([vals], np.float32).astype(ml_dtypes.bfloat16)
    g = np.asarray(x, np.float32)
    assert np.array_equal(np.asarray(vals, np.float32), g[0])          # bf16-exact values
    sq = (g * g).astype(np.float32)
    assert np_butterfly(sq) != np_left_to_right(sq)
    eye = np.eye(n, dtype=np.float32).astype(ml_dtypes.bfloat16)
    if fmt == "mx":
        bfly = np_quantize_mx(x, eye, n, "quest")[1]
        l2r = np_quantize_mx(x, eye, n, "quest", sums=np_left_to_right)[1]
        got = E.fused_quantize_mx_ordered_plain(to_torch(x), to_torch(eye), rot_size=n,
                                                layout="kmajor")[1]
    else:
        bfly = np_quantize_nv(x, eye, n, "quest", GS)[1]
        l2r = np_quantize_nv(x, eye, n, "quest", GS, sums=np_left_to_right)[1]
        got = E.fused_quantize_nv_ordered_plain(to_torch(x), to_torch(eye), GS, rot_size=n,
                                                method="quest", layout="kmajor")[1]
    assert bfly[0, 0] != l2r[0, 0]
    assert got.numpy()[0, 0] == bfly[0, 0]
