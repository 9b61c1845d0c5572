"""The port's public API against the JAX package's where the two used to
differ: ``out_dtype`` on the int8 and fp4 K-major GEMMs, ``backend`` on
the tn GEMMs, and ``QuantizedLinear`` (JAX's positional form, ``create``
at QuEST for fp4 and int8 storage, and JAX's abs-max alpha, which the
port does not copy).  CPU tensors: each kernel's plain version.

Tolerances: the int8 GEMMs bitwise in bf16 and fp32.  The fp4 GEMMs:
the port equals the fp64 sum of the exact products rounded once to fp32
(bitwise against that golden), and JAX bitwise in bf16 and fp32 on
quantizer outputs, where every partial sum is exact in fp32.  The JAX
emulation sums in fp32 through XLA's dot, so where a row pair's
products span more binades than fp32 holds (the "wide" cases: scales
2^+-30 for MX, e4m3 448 and 2^-9 for NV) its sum rounds and the port's
does not; there JAX is held to the fp32 summation bound, K * 2^-24 *
sum |a_k b_k|, and the port to the golden.  QuantizedLinear bitwise in
every output row whose quantized activation bytes (and, for int8
storage, whose activation deficit <= 3) equal JAX's.
"""
import numpy as np
import ml_dtypes
import jax.numpy as jnp
import pytest
import torch

import qutlass_tpu as q
import qutlass_tpu_torch as qt
from qutlass_tpu.formats import golden as G
from qutlass_tpu.nn.linear import QuantizedLinear as JQuantizedLinear
from qutlass_tpu.ops import int8path as JI8
from qutlass_tpu_torch.nn.linear import QuantizedLinear
from qutlass_tpu_torch.ops import emulation as E
from qutlass_tpu_torch.ops import int8path as TI8
from torch_helpers import hadamard_np, randn_bf16, to_np, to_torch

OUT = {"bf16": (torch.bfloat16, jnp.bfloat16), "f32": (torch.float32, jnp.float32)}


def _raw(y) -> np.ndarray:
    """The bits of a bf16 or fp32 result, as unsigned integers."""
    y = to_np(y) if isinstance(y, torch.Tensor) else np.asarray(y)
    return y.view(np.uint16 if y.dtype.itemsize == 2 else np.uint32)


def _int8_operands(m, n, k, seed):
    rng = np.random.default_rng(seed)
    at = rng.integers(-127, 128, (k, m), dtype=np.int8)
    bt = rng.integers(-127, 128, (k, n), dtype=np.int8)
    sa = rng.uniform(0.01, 2.0, m).astype(np.float32)
    sb = rng.uniform(0.01, 2.0, n).astype(np.float32)
    return at, bt, sa, sb


@pytest.mark.parametrize("out", ["bf16", "f32"])
@pytest.mark.parametrize("order", ["nk", "kmajor", "kk"])
@pytest.mark.parametrize("m,n,k", [(4, 96, 256), (33, 40, 512)])
def test_int8_gemms_out_dtype_bitwise_vs_jax(order, out, m, n, k):
    at, bt, sa, sb = _int8_operands(m, n, k, seed=m + n)
    alpha = np.float32(0.37)
    tdt, jdt = OUT[out]
    a_ = {"nk": at.T.copy(), "kmajor": at, "kk": at}[order]
    b_ = {"nk": bt.T.copy(), "kmajor": bt.T.copy(), "kk": bt}[order]
    fn = {"nk": "matmul_mxf4_bf16_int8", "kmajor": "matmul_mxf4_bf16_int8_kmajor",
          "kk": "matmul_mxf4_bf16_int8_kk"}[order]
    want = getattr(JI8, fn)(jnp.asarray(a_), jnp.asarray(b_), jnp.asarray(sa), jnp.asarray(sb),
                            jnp.float32(alpha), out_dtype=jdt)
    got = getattr(TI8, fn)(to_torch(a_), to_torch(b_), to_torch(sa), to_torch(sb), float(alpha),
                           out_dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(_raw(got), _raw(want))
    if out == "f32":      # the bf16 output is the fp32 one rounded once
        bf = getattr(TI8, fn)(to_torch(a_), to_torch(b_), to_torch(sa), to_torch(sb),
                              float(alpha))
        assert torch.equal(got.to(torch.bfloat16), bf)


def test_int8_gemm_rejects_other_out_dtypes():
    at, bt, sa, sb = _int8_operands(4, 8, 64, seed=1)
    with pytest.raises(ValueError):
        TI8.matmul_mxf4_bf16_int8_kk(to_torch(at), to_torch(bt), to_torch(sa), to_torch(sb),
                                     1.0, out_dtype=torch.float16)


def _fp4_operands(fmt, m, n, k, seed):
    """K-major operands from the JAX quantizer (numpy bytes) and alpha."""
    rng = np.random.default_rng(seed)
    h = jnp.asarray(hadamard_np(32))
    xa, xb = jnp.asarray(randn_bf16(rng, m, k)), jnp.asarray(randn_bf16(rng, n, k, scale=0.05))
    if fmt == "mx":
        a, b = (q.fusedQuantizeMx(x, h, layout="kmajor") for x in (xa, xb))
    else:
        gs = jnp.float32(40.0)
        a, b = (q.fusedQuantizeNv(x, h, gs, layout="kmajor") for x in (xa, xb))
    return [np.asarray(t) for t in (a[0], b[0], a[1], b[1])], np.float32(0.625)


def _wide_operands(fmt, m, n, k, seed):
    """Random K-major codes under alternating group scales far apart."""
    rng = np.random.default_rng(seed)
    gs = 32 if fmt == "mx" else 16
    hi, lo = (157, 97) if fmt == "mx" else (0x7E, 0x01)     # 2^+-30; e4m3 448, 2^-9
    ops = []
    for rows in (m, n):
        codes = rng.integers(0, 256, (k // 2, rows), dtype=np.uint8)
        scales = np.where((np.arange(k // gs) % 2 == 0)[:, None], hi, lo).astype(np.uint8)
        ops.append((codes, np.repeat(scales, rows, axis=1)))
    (at, ast), (bt, bst) = ops
    return [at, bt, ast, bst], np.float32(0.625)


def _dequant(fmt, packed_t, scales_t):
    """K-major packed operand -> exact fp64 values [rows, K]."""
    a, s = packed_t.T.copy(), scales_t.T.copy()
    if fmt == "mx":
        return np.asarray(G.dq_fp4(a, s, 32, 1.0), np.float64)
    return E.dequant_nvfp4(E.unpack_codes(to_torch(a)), to_torch(s)).double().numpy()


@pytest.mark.parametrize("out", ["bf16", "f32"])
@pytest.mark.parametrize("fmt", ["mx", "nv"])
@pytest.mark.parametrize("m,n,k,wide", [(4, 64, 512, False), (40, 96, 1024, False),
                                        (8, 32, 512, True)])
def test_fp4_kmajor_gemms_out_dtype(fmt, out, m, n, k, wide):
    make = _wide_operands if wide else _fp4_operands
    (at, bt, ast, bst), alpha = make(fmt, m, n, k, seed=k + m)
    tdt, jdt = OUT[out]
    name = f"matmul_{fmt}f4_bf16_kmajor"
    want = getattr(q, name)(*(jnp.asarray(t) for t in (at, bt, ast, bst)),
                            jnp.asarray([alpha]), out_dtype=jdt)
    got = getattr(qt, name)(*(to_torch(t) for t in (at, bt, ast, bst)), float(alpha),
                            out_dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == (m, n)
    da, db = _dequant(fmt, at, ast), _dequant(fmt, bt, bst)
    golden = (da @ db.T).astype(np.float32) * alpha
    if out == "bf16":
        np.testing.assert_array_equal(_raw(got), _raw(golden.astype(ml_dtypes.bfloat16)))
        if not wide:
            np.testing.assert_array_equal(_raw(got), _raw(want))
        return
    np.testing.assert_array_equal(_raw(got), golden.view(np.uint32))
    if wide:
        bound = k * 2.0 ** -24 * (np.abs(da) @ np.abs(db).T) * alpha
        assert (np.abs(np.asarray(want, np.float64) - golden) <= bound).all()
    else:
        np.testing.assert_array_equal(_raw(got), _raw(want))
    default = getattr(qt, name)(*(to_torch(t) for t in (at, bt, ast, bst)), float(alpha))
    assert torch.equal(got.to(torch.bfloat16), default)


@pytest.mark.parametrize("fmt", ["mx", "nv"])
def test_tn_gemms_backend(fmt, monkeypatch):
    """``backend=None`` takes the device route (on CPU tensors the plain
    version, through the kernel wrapper), ``"emulation"`` the plain version
    without the wrapper, anything else raises; JAX's emulation agrees."""
    (at, bt, ast, bst), alpha = _fp4_operands(fmt, 8, 64, 256, seed=11)
    a, b, as_, bs_ = (t.T.copy() for t in (at, bt, ast, bst))
    name = f"matmul_{fmt}f4_bf16_tn"
    args = [to_torch(t) for t in (a, b, as_, bs_)]
    want = getattr(q, name)(*(jnp.asarray(t) for t in (a, b, as_, bs_)), jnp.asarray([alpha]),
                            backend="emulation")
    y_none = getattr(qt, name)(*args, float(alpha), backend=None)
    y_emu = getattr(qt, name)(*args, float(alpha), backend="emulation")
    for y in (y_none, y_emu):
        np.testing.assert_array_equal(_raw(y), _raw(want))
    with pytest.raises(ValueError):
        getattr(qt, name)(*args, float(alpha), backend="pallas")

    def refuse(*_a, **_k):
        raise AssertionError("the device route ran")
    monkeypatch.setattr(qt._ops, name, refuse)
    assert torch.equal(getattr(qt, name)(*args, float(alpha), backend="emulation"), y_emu)
    with pytest.raises(AssertionError):
        getattr(qt, name)(*args, float(alpha))


def _linear_case(seed, n=96, k=512, rows=(3, 7)):
    rng = np.random.default_rng(seed)
    w = randn_bf16(rng, n, k, scale=k ** -0.5)
    x = randn_bf16(rng, *rows, k)
    return w, x, hadamard_np(32)


def _same_activation_rows(x2, h, method):
    """Rows whose K-major quantized activation bytes the two packages
    give bit for bit (and the port's activation deficit per row)."""
    jq, js = q.fusedQuantizeMx(jnp.asarray(x2), jnp.asarray(h), method=method, layout="kmajor")
    tq, ts = qt.fusedQuantizeMx(to_torch(x2), to_torch(h), method=method, layout="kmajor")
    same = (np.asarray(jq) == tq.numpy()).all(0) & (np.asarray(js) == ts.numpy()).all(0)
    se = ts.to(torch.int32)
    return same, (se.amax(0) - se).amax(0).numpy()


@pytest.mark.parametrize("storage", ["fp4", "int8"])
def test_quantized_linear_create_matches_jax_at_quest(storage):
    w, x, h = _linear_case(21)
    jl = JQuantizedLinear.create(jnp.asarray(w), jnp.asarray(h), method="quest")
    tl = QuantizedLinear.create(to_torch(w), to_torch(h), method="quest", weight_format=storage)
    if storage == "fp4":
        np.testing.assert_array_equal(tl.wqt.numpy(), np.asarray(jl.wqt))
        np.testing.assert_array_equal(tl.wst.numpy(), np.asarray(jl.wst))
    else:
        assert set(dict(tl.named_buffers())) == {"wi8", "wsb", "h"}
    want, got = np.asarray(jl(jnp.asarray(x))), tl(to_torch(x))
    assert got.shape == want.shape == (*x.shape[:-1], w.shape[0])
    same, deficit = _same_activation_rows(x.reshape(-1, x.shape[-1]), h, "quest")
    rows = same & (deficit <= 3) if storage == "int8" else same
    assert rows.mean() >= 0.9
    np.testing.assert_array_equal(_raw(got).reshape(-1, w.shape[0])[rows],
                                  _raw(want).reshape(-1, w.shape[0])[rows])


@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_quantized_linear_from_kmajor_takes_jax_arguments(method):
    """JAX's ``QuantizedLinear(wqt, wst, h, n, k, method)`` as
    ``from_kmajor``: the same bytes give JAX's output at QuEST; at abs-max
    the port folds the 1/9 that JAX's class leaves out (the trap: JAX's
    output is ~9x the true one)."""
    w, x, h = _linear_case(22, rows=(6,))
    n, k = w.shape
    wqt, wst = q.fusedQuantizeMx(jnp.asarray(w), jnp.asarray(h), method=method, layout="kmajor")
    jl = JQuantizedLinear(wqt, wst, jnp.asarray(h), n, k, method)
    tl = QuantizedLinear.from_kmajor(to_torch(wqt), to_torch(wst), to_torch(h), n, k, method)
    assert set(dict(tl.named_buffers())) == {"wqt", "wst", "h"}
    want, got = np.asarray(jl(jnp.asarray(x))).astype(np.float32), tl(to_torch(x))
    same, _ = _same_activation_rows(x, h, method)
    assert same.mean() >= 0.8
    g = got.float().numpy()
    ref = x.astype(np.float32) @ w.astype(np.float32).T
    if method == "quest":
        np.testing.assert_array_equal(_raw(got)[same], _raw(jl(jnp.asarray(x)))[same])
    else:
        np.testing.assert_allclose(9.0 * g[same], want[same], rtol=2e-2, atol=1e-6)
        ratio = np.linalg.norm(g) / np.linalg.norm(ref)
        assert 0.8 < ratio < 1.2 and 7.0 < np.linalg.norm(want) / np.linalg.norm(ref) < 11.0
    with pytest.raises(ValueError):
        QuantizedLinear.from_kmajor(to_torch(wqt), to_torch(wst), to_torch(h), n + 1, k, method)
