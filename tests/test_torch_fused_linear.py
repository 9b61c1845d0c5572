"""The port's single-kernel quantized linear (``fused_linear_mxf4`` /
``fused_linear_nvf4`` on CPU tensors: the composition K1 + K4 / K5 + K7
and the plain versions of kernels K16 / K17, picked by
``QUTLASS_TPU_FUSED_LINEAR``) against the JAX package's
``q.fused_linear_*`` on the CPU and TPU kernel #8
(``qutlass_tpu/kernels/fused_linear.py``) in Pallas interpret mode, fed
the same numpy inputs and the same quantized weight bytes; and the last
API names of the JAX package the port lacked.

Tolerances: bitwise everywhere; an output that is NaN must be NaN in the
other (a NaN's sign bit aside).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import qutlass_tpu as q
import qutlass_tpu.utils as JU
import qutlass_tpu_torch as qt
from qutlass_tpu.kernels import fused_linear as KF
from qutlass_tpu_torch.nn import linear as TL
from qutlass_tpu_torch.ops import cuda_ops
from torch_helpers import hadamard_np, randn_bf16, to_np, to_torch

SWITCH = "QUTLASS_TPU_FUSED_LINEAR"
ROUTES = ("", "1")           # the composition, the single kernel's plain version
# (m, k, n) per rotation size: every M, N and K of the slice at least once
SHAPES = {16: (1, 256, 64), 32: (3, 1024, 96), 64: (16, 256, 512), 128: (200, 1024, 512)}


def _same(got, want) -> None:
    """bf16 outputs equal bit for bit, NaN where the other is NaN."""
    g = (to_np(got) if isinstance(got, torch.Tensor) else np.asarray(got)).view(np.uint16)
    w = np.asarray(want).view(np.uint16)
    assert g.shape == w.shape
    gn, wn = (g & 0x7FFF) > 0x7F80, (w & 0x7FFF) > 0x7F80
    np.testing.assert_array_equal(gn, wn)
    np.testing.assert_array_equal(g[~gn], w[~wn])


def _port(monkeypatch, route, fn, *args, **kw):
    monkeypatch.setenv(SWITCH, route)
    try:
        return fn(*args, **kw)
    finally:
        monkeypatch.delenv(SWITCH)


def _pallas(fn, *args, **kw):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(*args, **kw))


def _data(m, k, n, seed, rows_special=False):
    rng = np.random.default_rng(seed)
    x = randn_bf16(rng, m, k, scale=2.0)
    w = randn_bf16(rng, n, k, scale=0.05)
    if rows_special:
        x[0] = np.nan
        x[m // 2] = 0.0
    return x, w


def _mx_case(monkeypatch, x, w, h, method, alpha=None, pallas=True):
    """JAX's weight bytes; the port's two routes, JAX's q.fused_linear_mxf4
    and (for K % 128 == 0) the Pallas kernel all give the same bits."""
    jh = jnp.asarray(h)
    wqt, wst = q.fusedQuantizeMx(jnp.asarray(w), jh, method=method, layout="kmajor")
    ja = None if alpha is None else jnp.asarray([alpha], jnp.float32)
    want = np.asarray(q.fused_linear_mxf4(jnp.asarray(x), wqt, wst, jh, ja, method=method))
    ta = None if alpha is None else torch.tensor([alpha])
    for route in ROUTES:
        got = _port(monkeypatch, route, qt.fused_linear_mxf4, to_torch(x), to_torch(wqt),
                    to_torch(wst), to_torch(h), ta, method=method)
        assert got.dtype == torch.bfloat16
        _same(got, want)
    if pallas:
        one = jnp.ones((1,), jnp.float32) if ja is None else ja
        x2 = jnp.asarray(x).reshape(-1, x.shape[-1])
        _same(want.reshape(x2.shape[0], -1),
              _pallas(KF.fused_linear_mxf4, x2, wqt, wst, jh, one, rot_size=h.shape[0],
                      method=method))
    return want


def _nv_case(monkeypatch, x, w, h, method, gsx, alpha=None, pallas=True):
    """The NV twin of :func:`_mx_case`: the weight quantized under its own
    global scale, the activation under ``gsx``."""
    jh = jnp.asarray(h)
    wqt, wst = q.fusedQuantizeNv(jnp.asarray(w), jh, jnp.float32(300.0), method=method,
                                 layout="kmajor")
    ja = None if alpha is None else jnp.asarray([alpha], jnp.float32)
    want = np.asarray(q.fused_linear_nvf4(jnp.asarray(x), wqt, wst, jh, jnp.float32(gsx), ja,
                                          method=method))
    ta = None if alpha is None else torch.tensor([alpha])
    for route in ROUTES:
        got = _port(monkeypatch, route, qt.fused_linear_nvf4, to_torch(x), to_torch(wqt),
                    to_torch(wst), to_torch(h), torch.tensor(gsx), ta, method=method)
        _same(got, want)
    if pallas:
        one = jnp.ones((1,), jnp.float32) if ja is None else ja
        x2 = jnp.asarray(x).reshape(-1, x.shape[-1])
        _same(want.reshape(x2.shape[0], -1),
              _pallas(KF.fused_linear_nvf4, x2, wqt, wst, jh, jnp.float32(gsx), one,
                      rot_size=h.shape[0], method=method))
    return want


@pytest.mark.parametrize("rot", sorted(SHAPES))
@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_fused_linear_mx_matches_jax_and_pallas(monkeypatch, method, rot):
    m, k, n = SHAPES[rot]
    x, w = _data(m, k, n, rot)
    _mx_case(monkeypatch, x, w, hadamard_np(rot), method)


@pytest.mark.parametrize("rot", sorted(SHAPES))
@pytest.mark.parametrize("method", ["abs_max", "quest"])
def test_fused_linear_nv_matches_jax_and_pallas(monkeypatch, method, rot):
    m, k, n = SHAPES[rot]
    x, w = _data(m, k, n, 10 + rot)
    _nv_case(monkeypatch, x, w, hadamard_np(rot), method, gsx=37.5)


@pytest.mark.parametrize("rot", [16, 32])
@pytest.mark.parametrize("fmt", ["mx", "nv"])
def test_fused_linear_partial_slab_k96(monkeypatch, fmt, rot):
    """K = 96, less than one of the kernels' 128-column slabs (the Pallas
    kernel takes K % 128 == 0 only; JAX runs it through its emulation)."""
    x, w = _data(16, 96, 96, 20 + rot)
    for method in ("quest", "abs_max"):
        if fmt == "mx":
            _mx_case(monkeypatch, x, w, hadamard_np(rot), method, pallas=False)
        else:
            _nv_case(monkeypatch, x, w, hadamard_np(rot), method, 5.0, pallas=False)


@pytest.mark.parametrize("rotation", ["dct", "identity"])
@pytest.mark.parametrize("fmt", ["mx", "nv"])
def test_fused_linear_other_rotations(monkeypatch, fmt, rotation):
    x, w = _data(16, 256, 64, 30)
    h = np.asarray(JU.dct_matrix(32) if rotation == "dct" else JU.identity_matrix(32))
    for method in ("quest", "abs_max"):
        if fmt == "mx":
            _mx_case(monkeypatch, x, w, h, method)
        else:
            _nv_case(monkeypatch, x, w, h, method, 2.0)


@pytest.mark.parametrize("fmt", ["mx", "nv"])
def test_fused_linear_batched_alpha_nan_and_zero_rows(monkeypatch, fmt):
    """A [B, T, K] input keeps its leading dims; alpha 0.7 (for MX
    abs-max the fp32 product 0.7 * float32(1/9)); a NaN row and a zero
    row."""
    x, w = _data(24, 256, 96, 40, rows_special=True)
    x = x.reshape(2, 12, 256)
    h = hadamard_np(32)
    for method in ("quest", "abs_max"):
        if fmt == "mx":
            want = _mx_case(monkeypatch, x, w, h, method, alpha=0.7)
        else:
            want = _nv_case(monkeypatch, x, w, h, method, 3.0, alpha=0.7)
        y = want.astype(np.float32)
        assert y.shape == (2, 12, 96)
        assert np.isfinite(y[0, 1:]).all() and np.isfinite(y[1]).all()   # all but the NaN row
        assert (y[1, 0] == 0).all()                                      # the zero row


def test_fused_linear_default_alpha_and_fold():
    """alpha None is 1; MX abs-max folds alpha * float32(1/9) in fp32
    (not the double product rounded once), quest takes alpha as given."""
    x, w = _data(8, 256, 64, 50)
    h = to_torch(hadamard_np(32))
    tx = to_torch(x)
    for method in ("quest", "abs_max"):
        wqt, wst = qt.fusedQuantizeMx(to_torch(w), h, method=method, layout="kmajor")
        assert torch.equal(qt.fused_linear_mxf4(tx, wqt, wst, h, method=method),
                           qt.fused_linear_mxf4(tx, wqt, wst, h, 1.0, method=method))
        xqt, xst = qt.fusedQuantizeMx(tx, h, method=method, layout="kmajor")
        al = torch.tensor(0.7, dtype=torch.float32)
        if method != "quest":
            al = al * torch.tensor(1.0 / 9.0, dtype=torch.float32)
        want = qt.matmul_mxf4_bf16_kmajor(xqt, wqt, xst, wst, al)
        assert torch.equal(qt.fused_linear_mxf4(tx, wqt, wst, h, 0.7, method=method), want)


@pytest.mark.parametrize("route", ROUTES)
def test_fused_linear_quest_equals_the_row_major_gemm(monkeypatch, route):
    """examples/quickstart.py's check: for QuEST the single-kernel linear
    equals matmul_mxf4_bf16_tn of the row-major operands bit for bit."""
    x, w = _data(16, 512, 128, 60)
    h = to_torch(hadamard_np(32))
    tx, tw = to_torch(x), to_torch(w)
    wqt, wst = qt.fusedQuantizeMx(tw, h, layout="kmajor")
    got = _port(monkeypatch, route, qt.fused_linear_mxf4, tx, wqt, wst, h)
    xq, xs = qt.fusedQuantizeMx(tx, h)
    wq, ws = qt.fusedQuantizeMx(tw, h)
    want = qt.matmul_mxf4_bf16_tn(xq, wq, qt.to_blocked(xs), qt.to_blocked(ws), 1.0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("switch,single", [("", False), ("0", False), ("1", True),
                                           ("yes", True)])
def test_switch_picks_the_route(monkeypatch, switch, single):
    """The environment variable, read at every call, picks the single
    kernel or the composition, for both formats (on the CPU their plain
    versions)."""
    calls = []
    for name in ("fused_linear_mxf4", "fused_linear_nvf4", "fused_quantize_mx",
                 "fused_quantize_nv"):
        orig = getattr(cuda_ops, name)
        monkeypatch.setattr(cuda_ops, name,
                            lambda *a, _o=orig, _n=name, **k: calls.append(_n) or _o(*a, **k))
    x, w = _data(4, 256, 64, 70)
    h = to_torch(hadamard_np(16))
    tx, tw = to_torch(x), to_torch(w)
    mq, ms = qt.fusedQuantizeMx(tw, h, layout="kmajor")
    nq, ns = qt.fusedQuantizeNv(tw, h, 1.0, layout="kmajor")
    calls.clear()
    monkeypatch.setenv(SWITCH, switch)
    qt.fused_linear_mxf4(tx, mq, ms, h)
    qt.fused_linear_nvf4(tx, nq, ns, h, 2.0)
    want = (["fused_linear_mxf4", "fused_linear_nvf4"] if single
            else ["fused_quantize_mx", "fused_quantize_nv"])
    assert calls == want


@pytest.mark.parametrize("bad", ["k_mismatch", "scale_shape", "x_dtype", "rot", "nv_scale_shape",
                                 "method"])
def test_fused_linear_validation_errors(bad):
    x = torch.zeros((4, 256), dtype=torch.bfloat16)
    h = qt.hadamard_matrix(32, device="cpu")
    wqt = torch.zeros((128, 64), dtype=torch.uint8)
    mx_s = torch.zeros((8, 64), dtype=torch.uint8)
    nv_s = torch.zeros((16, 64), dtype=torch.uint8)
    fn, kw = qt.fused_linear_mxf4, {}
    if bad == "k_mismatch":
        x = torch.zeros((4, 512), dtype=torch.bfloat16)
    elif bad == "scale_shape":
        mx_s = torch.zeros((8, 63), dtype=torch.uint8)
    elif bad == "x_dtype":
        x = x.float()
    elif bad == "rot":
        h = qt.hadamard_matrix(8, device="cpu")
    elif bad == "method":
        kw = {"method": "absmax"}
    if bad == "nv_scale_shape":
        with pytest.raises(ValueError):
            qt.fused_linear_nvf4(x, wqt, mx_s, h, 1.0)
        return
    with pytest.raises((TypeError, ValueError)):
        fn(x, wqt, mx_s, h, **kw)
    if bad != "scale_shape":
        with pytest.raises((TypeError, ValueError)):
            qt.fused_linear_nvf4(x, wqt, nv_s, h, 1.0, **kw)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_quartet_linear_eval_reaches_fused_linear(monkeypatch, route, method):
    """QuartetLinear in eval mode calls fused_linear_mxf4 (as QuartetDense
    does) under both switch values, and equals JAX's bit for bit."""
    rng = np.random.default_rng(80)
    x, w = randn_bf16(rng, 2, 5, 256, scale=1.0), randn_bf16(rng, 96, 256, scale=256 ** -0.5)
    lin = TL.QuartetLinear(256, 96, rot_size=32, method=method, device="cpu").eval()
    with torch.no_grad():
        lin.weight.copy_(to_torch(w))
    seen = []
    orig = qt.fused_linear_mxf4
    monkeypatch.setattr(qt, "fused_linear_mxf4",
                        lambda *a, **k: seen.append(k.get("method")) or orig(*a, **k))
    with torch.no_grad():
        y = _port(monkeypatch, route, lin, to_torch(x))
    assert seen == [method] and tuple(y.shape) == (2, 5, 96)
    h = jnp.asarray(hadamard_np(32))
    wqt, wst = q.fusedQuantizeMx(jnp.asarray(w), h, method=method, layout="kmajor")
    _same(y, q.fused_linear_mxf4(jnp.asarray(x), wqt, wst, h, method=method))


# ---------------------------------------------------------------------------
# the last API names: dct_matrix, get_padded_shape_*, to_blocked_swizzled
# ---------------------------------------------------------------------------

def test_all_names_of_the_jax_package_are_exported():
    assert set(q.__all__) <= set(qt.__all__), set(q.__all__) - set(qt.__all__)
    for name in qt.__all__:
        assert hasattr(qt, name), name


@pytest.mark.parametrize("n", [16, 32, 64, 128])
def test_dct_matrix_matches_jax(n):
    got = qt.dct_matrix(n, device="cpu")
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (n, n)
    np.testing.assert_array_equal(to_np(got).view(np.uint16),
                                  np.asarray(JU.dct_matrix(n)).view(np.uint16))
    f32 = qt.dct_matrix(n, dtype=torch.float32, device="cpu").double()
    assert torch.allclose(f32 @ f32.T, torch.eye(n, dtype=torch.float64), atol=1e-6)


@pytest.mark.parametrize("shape", [(1, 32), (3, 200, 64), (128, 4096), (129, 96)])
def test_get_padded_shapes_match_jax(shape):
    a = np.zeros(shape, ml_dtypes.bfloat16)
    t = torch.zeros(shape, dtype=torch.bfloat16)
    assert qt.get_padded_shape_mx(t) == JU.get_padded_shape_mx(a)
    assert qt.get_padded_shape_nv(t) == JU.get_padded_shape_nv(a)


@pytest.mark.parametrize("rows,cols", [(128, 4), (256, 8), (384, 12)])
def test_to_blocked_swizzled_matches_jax(rows, cols):
    s = np.random.default_rng(rows).integers(0, 256, (rows, cols)).astype(np.uint8)
    got = qt.to_blocked_swizzled(torch.from_numpy(s))
    np.testing.assert_array_equal(got.numpy(), np.asarray(JU.to_blocked_swizzled(jnp.asarray(s))))
    with pytest.raises(ValueError):
        qt.to_blocked_swizzled(torch.from_numpy(s[:100]))
