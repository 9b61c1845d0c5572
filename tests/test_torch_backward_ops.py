"""The port's Quartet backward-operand ops (the plain versions of kernels
K12-K15, reached through the public ops on CPU tensors) fed the same
inputs as the JAX package, its Pallas kernels #9, #10, #13 and #14 in
interpret mode, and the fp64 golden.

Tolerances:
  * ``backward_t_bf16`` / ``backward_qt_bf16`` (K12 / K13): scale bytes
    equal to the fp64 golden and to the JAX package exactly; codes within
    the MX budget (1e-4 mismatch rate) of the JAX package (zero measured
    at these shapes) and dequantized values within it of the golden.  A
    zero or subnormal group takes the golden's scale 2^-127, where the
    JAX emulation divides by 0 (and XLA:CPU flushes subnormals): such
    groups are held to the golden alone.
  * ``mxfp4_transpose_scaled`` / ``_kmajor`` (K14 / K15): bitwise, a
    NaN's bf16 bits aside (PyTorch's CPU cast of a NaN sets the sign);
    groups that meet XLA:CPU's flush of subnormals are held to the
    decoded plain K10 alone.
  * The slice as a whole: the bf16 grad mode against the natural-order
    construction through K15 to tests/test_linear.py's rtol 8e-3 /
    atol 1e-4; the construction between the packages within cosine
    0.9999 (the unrotation's fp32 sums run in another order than XLA's);
    the wgrad operands of SURVEY.md 3.4 within gross-fault bounds.
"""
import ml_dtypes
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import qutlass_tpu as q
import qutlass_tpu_torch as qt
from qutlass_tpu.kernels import backward as KB
from qutlass_tpu.nn import linear as JL
from qutlass_tpu.ops import emulation as JE
from qutlass_tpu.formats import golden as G
from qutlass_tpu_torch.nn import linear as TL
from qutlass_tpu_torch.ops import emulation as TE
from torch_helpers import cosine, hadamard_np, randn_bf16, to_np, to_torch

BUDGET = 1e-4


def _bf16_same(got, want) -> bool:
    """bf16 bit patterns equal, a NaN matching any NaN."""
    g = to_np(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    gn, wn = np.isnan(g.astype(np.float32)), np.isnan(w.astype(np.float32))
    return bool(np.array_equal(gn, wn)) and bool(
        np.array_equal(g.view(np.uint16)[~gn], w.view(np.uint16)[~wn]))


def _codes(packed) -> np.ndarray:
    p = np.asarray(packed).astype(np.int32)
    return np.stack([p & 0xF, p >> 4], axis=-1).reshape(*p.shape[:-1], -1)


def _code_rate(got, want) -> float:
    return float((_codes(got.numpy()) != _codes(want)).mean())


def _fp4(m, n, method, seed, rot=32, scale=5.0):
    """The JAX package's row-major MXFP4 of a seeded bf16 [m, n]: (codes,
    the quantizer's padded scale buffer)."""
    x = jnp.asarray(randn_bf16(np.random.default_rng(seed), m, n, scale=scale))
    xq, xs = q.fusedQuantizeMx(x, jnp.asarray(hadamard_np(rot)), method=method)
    return np.asarray(xq), np.asarray(xs)


# ---------------------------------------------------------------------------
# #9 backward_t_bf16 (K12)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rot", [16, 32, 64, 128])
def test_backward_t_batched_vs_jax_and_golden(rot):
    """tests/test_quartet.py's batched [2, 512, 256] input at every
    rotation size."""
    x = randn_bf16(np.random.default_rng(0), 2, 512, 256)
    h = hadamard_np(rot)
    jq, js = q.backward_t_bf16(jnp.asarray(x), jnp.asarray(h))
    tq, ts = qt.backward_t_bf16(to_torch(x), to_torch(h))
    assert tq.shape == (2, 256, 256) and ts.shape == (2, 256, 16)
    ref = G.backward_quantize(np.swapaxes(x.astype(np.float64), -2, -1), h.astype(np.float64))
    np.testing.assert_array_equal(ts.numpy(), ref["e8m0"])
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert _code_rate(tq, jq) <= BUDGET
    assert np.array_equal(tq.numpy(), np.asarray(jq))      # bitwise at this shape
    dq = G.dq_fp4(tq.numpy(), ts.numpy(), 32, 3.0)
    assert (dq != ref["dq"]).mean() <= BUDGET


@pytest.mark.parametrize("n,k,rot", [(96, 64, 32), (256, 100, 16), (64, 96, 64), (128, 33, 128)])
def test_backward_t_other_shapes_vs_jax(n, k, rot):
    """N a multiple of 32 and of rot but not of 256, and any K (the JAX
    dispatcher sends these to its emulation)."""
    x = randn_bf16(np.random.default_rng(1), n, k, scale=3.0)
    h = hadamard_np(rot)
    jq, js = q.backward_t_bf16(jnp.asarray(x), jnp.asarray(h))
    tq, ts = qt.backward_t_bf16(to_torch(x), to_torch(h))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert _code_rate(tq, jq) <= BUDGET


@pytest.mark.parametrize("rot", [32, 128])
def test_backward_t_pallas_interpret(rot):
    """TPU kernel #9 in interpret mode equals the port."""
    x = randn_bf16(np.random.default_rng(2), 256, 512, scale=4.0)
    h = hadamard_np(rot)
    with pltpu.force_tpu_interpret_mode():
        pq, ps = KB.backward_t_bf16_2d(jnp.asarray(x), jnp.asarray(h), rot_size=rot)
    tq, ts = TE.backward_t_bf16(to_torch(x), to_torch(h), rot_size=rot)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(ps))
    assert _code_rate(tq, pq) <= BUDGET


def _zero_subnormal_input():
    """bf16 [256, 256] with 32 zero rows (a zero group along N in every
    column) and, in column 5, one group of fp32-subnormal values."""
    x = randn_bf16(np.random.default_rng(0), 256, 256).astype(np.float32)
    x[64:96] = 0.0
    x[128:160, 5] = np.random.default_rng(1).uniform(-1, 1, 32) * 2.0 ** -130
    return x.astype(ml_dtypes.bfloat16)


def test_backward_t_zero_and_subnormal_groups():
    """Zero groups get byte 0 and code bytes 0x00; the subnormal group is
    quantized under the golden's scale 2^-127.  Both equal the golden;
    every other group equals the JAX emulation and the Pallas kernel."""
    x, h = _zero_subnormal_input(), hadamard_np(32)
    tq, ts = (t.numpy() for t in qt.backward_t_bf16(to_torch(x), to_torch(h)))
    ref = G.backward_quantize(x.astype(np.float64).T, h.astype(np.float64))
    np.testing.assert_array_equal(ts, ref["e8m0"])
    np.testing.assert_array_equal(G.dq_fp4(tq, ts, 32, 3.0), ref["dq"])
    assert (tq[:, 32:48] == 0).all() and (ts[:, 2] == 0).all()
    assert ts[5, 4] == 0 and (tq[5, 64:80] != 0).any()     # subnormal values kept
    special = np.zeros(tq.shape, bool)
    special[:, 32:48] = True
    special[5, 64:80] = True
    jq, _ = JE.backward_t_bf16(jnp.asarray(x), jnp.asarray(h), rot_size=32)
    with pltpu.force_tpu_interpret_mode():
        pq, _ = KB.backward_t_bf16_2d(jnp.asarray(x), jnp.asarray(h), rot_size=32)
    np.testing.assert_array_equal(tq[~special], np.asarray(jq)[~special])
    np.testing.assert_array_equal(tq[~special], np.asarray(pq)[~special])
    # the Pallas kernel multiplies by 2^127 too: its zero groups are 0x00
    assert (np.asarray(pq)[:, 32:48] == 0).all()


def test_jax_emulation_zero_groups_are_0x88():
    """On record: the JAX emulation divides a zero group by its scale 0
    (0/0 = NaN, encoded as -0), so every such code byte is 0x88; the port
    writes 0x00.  Both dequantize to zero."""
    x, h = _zero_subnormal_input(), hadamard_np(32)
    jq, js = (np.asarray(t) for t in JE.backward_t_bf16(jnp.asarray(x), jnp.asarray(h),
                                                         rot_size=32))
    tq, _ = qt.backward_t_bf16(to_torch(x), to_torch(h))
    assert (jq[:, 32:48] == 0x88).all() and (tq.numpy()[:, 32:48] == 0).all()
    assert (G.dq_fp4(jq, js, 32, 3.0)[:, 64:96] == 0).all()


def test_backward_t_validation():
    h = qt.hadamard_matrix(32, device="cpu")
    with pytest.raises(TypeError):
        qt.backward_t_bf16(torch.zeros(64, 64), h)
    with pytest.raises(ValueError):                       # N not a multiple of 32
        qt.backward_t_bf16(torch.zeros(48, 64, dtype=torch.bfloat16),
                           qt.hadamard_matrix(16, device="cpu"))
    with pytest.raises(ValueError):                       # N not a multiple of rot
        qt.backward_t_bf16(torch.zeros(96, 64, dtype=torch.bfloat16),
                           qt.hadamard_matrix(64, device="cpu"))


# ---------------------------------------------------------------------------
# #10 backward_qt_bf16 (K13)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alpha", [1.0, 3.0])
@pytest.mark.parametrize("method", ["abs_max", "quest"])
def test_backward_qt_vs_jax_and_golden(alpha, method):
    """The quantizer's padded scale buffer as input (sliced by the op)."""
    m, n = 512, 256
    xq, xs = _fp4(m, n, method, 3)
    h = hadamard_np(32)
    al = np.array([alpha], np.float32)
    jq, js = q.backward_qt_bf16(jnp.asarray(xq), jnp.asarray(xs), jnp.asarray(h),
                                jnp.asarray(al))
    tq, ts = qt.backward_qt_bf16(to_torch(xq), to_torch(xs), to_torch(h), to_torch(al))
    assert tq.shape == (n, m // 2) and ts.shape == (n, m // 32)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert _code_rate(tq, jq) <= BUDGET
    ref = G.backward_quantize(G.dq_fp4(xq, xs[:m, :n // 32], 32, alpha).T, h.astype(np.float64))
    np.testing.assert_array_equal(ts.numpy(), ref["e8m0"])
    assert (G.dq_fp4(tq.numpy(), ts.numpy(), 32, 3.0) != ref["dq"]).mean() <= BUDGET


@pytest.mark.parametrize("m,n,rot", [(96, 64, 32), (128, 96, 128), (64, 512, 16)])
def test_backward_qt_other_shapes_vs_jax(m, n, rot):
    xq, xs = _fp4(m, n, "abs_max", 4)
    xs = xs[:m, :n // 32]       # the JAX op slices a padded buffer's columns only
    h = hadamard_np(rot)
    jq, js = q.backward_qt_bf16(jnp.asarray(xq), jnp.asarray(xs), jnp.asarray(h),
                                jnp.asarray([3.0], jnp.float32))
    tq, ts = qt.backward_qt_bf16(to_torch(xq), to_torch(xs), to_torch(h), 3.0)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert _code_rate(tq, jq) <= BUDGET


def test_backward_qt_batched_vs_jax():
    """A batched [2, 256, 128] operand with [2, 256, 4] scales."""
    rng = np.random.default_rng(5)
    xq = rng.integers(0, 256, (2, 256, 64), dtype=np.uint8)
    xs = rng.integers(118, 136, (2, 256, 4), dtype=np.uint8)
    h = hadamard_np(32)
    jq, js = q.backward_qt_bf16(jnp.asarray(xq), jnp.asarray(xs), jnp.asarray(h),
                                jnp.asarray([3.0], jnp.float32))
    tq, ts = qt.backward_qt_bf16(to_torch(xq), to_torch(xs), to_torch(h), 3.0)
    assert tq.shape == (2, 128, 128) and ts.shape == (2, 128, 8)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert _code_rate(tq, jq) <= BUDGET
    for i in range(2):      # each batch entry is the 2-D op on its slice
        sq, ss = qt.backward_qt_bf16(to_torch(xq[i]), to_torch(xs[i]), to_torch(h), 3.0)
        assert torch.equal(sq, tq[i]) and torch.equal(ss, ts[i])


@pytest.mark.parametrize("method", ["abs_max", "quest"])
def test_backward_qt_pallas_interpret(method):
    """TPU kernel #10 in interpret mode (alpha 3) equals the port."""
    xq, xs = _fp4(256, 512, method, 6)
    xs = xs[:256, :16]
    h = hadamard_np(32)
    al = jnp.asarray([3.0], jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        pq, ps = KB.backward_qt_bf16_2d(jnp.asarray(xq), jnp.asarray(xs), jnp.asarray(h), al,
                                        rot_size=32)
    tq, ts = TE.backward_qt_bf16(to_torch(xq), to_torch(xs), to_torch(h), 3.0, rot_size=32)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(ps))
    assert _code_rate(tq, pq) <= BUDGET


def test_backward_qt_extreme_scale_vs_jax():
    """Input scale bytes 248..252 put the output scales near the top of
    the e8m0 range (scale * alpha up to 1.5 * 2^127): bitwise against the
    JAX emulation, whose arithmetic the port copies."""
    rng = np.random.default_rng(7)
    m, n = 256, 128
    xq = rng.integers(0, 256, (m, n // 2), dtype=np.uint8)
    xs = rng.integers(248, 253, (m, n // 32), dtype=np.uint8)
    h = hadamard_np(32)
    jq, js = JE.backward_qt_bf16(jnp.asarray(xq), jnp.asarray(xs), jnp.asarray(h),
                                 jnp.asarray(3.0, jnp.float32), rot_size=32)
    tq, ts = qt.backward_qt_bf16(to_torch(xq), to_torch(xs), to_torch(h), 3.0)
    assert ts.numpy().max() >= 250
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


@pytest.mark.parametrize("alpha", [1.0, 3.0])
def test_backward_qt_zero_and_subnormal_groups(alpha):
    """Zero groups (code 0 rows) and groups whose amax / alpha is an fp32
    subnormal (input scale byte 1) get byte 0 and the golden's scale
    2^-127, also at alpha 1, where 3 / (2^-127 * alpha) overflows fp32:
    equal to the golden; the other groups equal the JAX emulation."""
    rng = np.random.default_rng(8)
    m, n = 256, 128
    xq = rng.integers(0, 256, (m, n // 2), dtype=np.uint8)
    xs = rng.integers(120, 134, (m, n // 32), dtype=np.uint8)
    xq[32:64] = 0                   # a zero group along M in every column
    xs[64:96, 1] = 0                # scale 2^-127 and magnitudes <= 0.5 in columns
    xq[64:96, 16:32] &= 0x11        # 32..63: amax / alpha an fp32 subnormal
    h = hadamard_np(32)
    tq, ts = (t.numpy() for t in qt.backward_qt_bf16(to_torch(xq), to_torch(xs),
                                                     to_torch(h), alpha))
    ref = G.backward_quantize(G.dq_fp4(xq, xs, 32, alpha).T, h.astype(np.float64))
    np.testing.assert_array_equal(ts, ref["e8m0"])
    assert (ts[:, 1] == 0).all() and (ts[32:64, 2] == 0).all()
    assert (tq[:, 16:32] == 0).all()
    dq = G.dq_fp4(tq, ts, 32, 3.0)
    np.testing.assert_array_equal(dq[:, 32:64], ref["dq"][:, 32:64])
    np.testing.assert_array_equal(dq[32:64, 64:96], ref["dq"][32:64, 64:96])
    jq, js = JE.backward_qt_bf16(jnp.asarray(xq), jnp.asarray(xs), jnp.asarray(h),
                                 jnp.asarray(alpha, jnp.float32), rot_size=32)
    keep = ts != 0
    np.testing.assert_array_equal(ts[keep], np.asarray(js)[keep])
    keep_b = np.repeat(keep, 16, axis=1)
    np.testing.assert_array_equal(tq[keep_b], np.asarray(jq)[keep_b])


def test_backward_qt_validation():
    h = qt.hadamard_matrix(32, device="cpu")
    xq = torch.zeros(96, 32, dtype=torch.uint8)
    with pytest.raises(ValueError):                       # scales too small
        qt.backward_qt_bf16(xq, torch.zeros(96, 1, dtype=torch.uint8), h, 3.0)
    with pytest.raises(ValueError):                       # M not a multiple of rot
        qt.backward_qt_bf16(xq, torch.zeros(96, 2, dtype=torch.uint8),
                            qt.hadamard_matrix(64, device="cpu"), 3.0)
    with pytest.raises(ValueError):                       # batched scales too small
        qt.backward_qt_bf16(xq[None], torch.zeros(1, 64, 2, dtype=torch.uint8), h, 3.0)


# ---------------------------------------------------------------------------
# #13 mxfp4_transpose_scaled (K14)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n", [(300, 256), (422, 64), (256, 512)])
@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_mxfp4_transpose_scaled_vs_jax(m, n, method):
    """The public op on the quantizer's padded buffer, M padded to 256
    under unit scales, bitwise."""
    xq, xs = _fp4(m, n, method, 9)
    want = q.mxfp4_transpose_scaled(jnp.asarray(xq), jnp.asarray(xs))
    got = qt.mxfp4_transpose_scaled(to_torch(xq), to_torch(xs))
    assert got.shape == (n, -(-m // 256) * 256)
    assert _bf16_same(got, want)


def test_mxfp4_transpose_scaled_every_scale_byte():
    """Scale bytes 0..255 under random codes: equal to the decode of the
    plain K10 bitwise, and to the JAX emulation except groups that meet
    XLA:CPU's flush of subnormals (a decoded value, a shared scale or an
    output below 2^-126)."""
    rng = np.random.default_rng(10)
    m, n = 256, 2048
    xq = rng.integers(0, 256, (m, n // 2), dtype=np.uint8)
    xs = (np.arange(m * n // 32) % 256).astype(np.uint8).reshape(m, n // 32)
    got = TE.mxfp4_transpose_scaled(to_torch(xq), to_torch(xs))
    fp8, eb = TE.mxfp4_transpose_mxfp8(to_torch(xq), to_torch(xs))
    dec = (G.e4m3_to_f64(fp8.numpy()) * np.repeat(G.e8m0_to_f64(eb.numpy()), 32, axis=1))
    with np.errstate(over="ignore"):                  # products past the fp32 range: inf
        assert _bf16_same(got, dec.astype(np.float32).astype(ml_dtypes.bfloat16))
    want = np.asarray(JE.mxfp4_transpose_scaled(jnp.asarray(xq), jnp.asarray(xs)))
    g = np.abs(G.dq_fp4(xq, xs, 32, 1.0).T).reshape(n, m // 32, 32)
    with np.errstate(invalid="ignore"):
        flushed = ((g > 0) & (g < 2.0 ** -110)).any(-1) | (g.max(-1) < 2.0 ** -100)
    keep = np.repeat(~flushed, 32, axis=1)
    assert _bf16_same(to_np(got)[keep], want[keep])
    assert keep.mean() > 0.7


@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_mxfp4_transpose_scaled_pallas_interpret(method):
    """TPU kernel #13 in interpret mode equals the port."""
    xq, xs = _fp4(256, 512, method, 11)
    xs = xs[:256, :16]
    with pltpu.force_tpu_interpret_mode():
        want = KB.mxfp4_transpose_scaled_2d(jnp.asarray(xq), jnp.asarray(xs))
    assert _bf16_same(TE.mxfp4_transpose_scaled(to_torch(xq), to_torch(xs)), want)


# ---------------------------------------------------------------------------
# #14 mxfp4_transpose_scaled_kmajor (K15)
# ---------------------------------------------------------------------------

def _fp4_kmajor(rows, k, method, seed, rot=32):
    x = jnp.asarray(randn_bf16(np.random.default_rng(seed), rows, k, scale=2.0))
    xqt, xst = q.fusedQuantizeMx(x, jnp.asarray(hadamard_np(rot)), method=method,
                                 layout="kmajor")
    return np.asarray(xqt), np.asarray(xst)


@pytest.mark.parametrize("rows,k", [(256, 512), (300, 512), (300, 96), (17, 64)])
def test_mxfp4_transpose_scaled_kmajor_vs_jax(rows, k):
    qk, sk = _fp4_kmajor(rows, k, "quest", 12)
    want = q.mxfp4_transpose_scaled_kmajor(jnp.asarray(qk), jnp.asarray(sk))
    got = qt.mxfp4_transpose_scaled_kmajor(to_torch(qk), to_torch(sk))
    assert got.shape == (k, rows)
    assert _bf16_same(got, want)


@pytest.mark.parametrize("rows", [256, 300])
@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_mxfp4_transpose_scaled_kmajor_equals_rowmajor(rows, method):
    """#14 on the K-major operand equals #13 on its row-major repack (the
    transposed bytes), with the row-major quantizer's own output too."""
    k = 256
    qk, sk = _fp4_kmajor(rows, k, method, 13)
    got = qt.mxfp4_transpose_scaled_kmajor(to_torch(qk), to_torch(sk))
    rm = qt.mxfp4_transpose_scaled(to_torch(np.ascontiguousarray(qk.T)),
                                   to_torch(np.ascontiguousarray(sk.T)))
    assert torch.equal(got.view(torch.int16), rm[:, :rows].view(torch.int16))
    xq, xs = _fp4(rows, k, method, 13, scale=2.0)
    x2 = qt.mxfp4_transpose_scaled(to_torch(xq), to_torch(xs))
    assert torch.equal(got.view(torch.int16), x2[:, :rows].view(torch.int16))


def test_mxfp4_transpose_scaled_kmajor_every_scale_byte():
    """Every scale byte (0 and 255 included) through the K-major route
    equals the row-major plain route bitwise."""
    rng = np.random.default_rng(14)
    rows, k = 288, 2048
    qk = rng.integers(0, 256, (k // 2, rows), dtype=np.uint8)
    sk = (np.arange(k // 32 * rows) % 256).astype(np.uint8).reshape(k // 32, rows)
    got = qt.mxfp4_transpose_scaled_kmajor(to_torch(qk), to_torch(sk))
    pad = np.full((512, k // 32), 127, np.uint8)
    pad[:rows] = sk.T
    xq = np.zeros((512, k // 2), np.uint8)
    xq[:rows] = qk.T
    want = TE.mxfp4_transpose_scaled(to_torch(xq), to_torch(pad))[:, :rows]
    assert _bf16_same(got, to_np(want))


@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_mxfp4_transpose_scaled_kmajor_pallas_interpret(method):
    """TPU kernel #14 in interpret mode (K % 256 == 0) equals the port."""
    qk, sk = _fp4_kmajor(256, 512, method, 15)
    with pltpu.force_tpu_interpret_mode():
        want = KB.mxfp4_transpose_scaled_kmajor_2d(jnp.asarray(qk), jnp.asarray(sk))
    assert _bf16_same(TE.mxfp4_transpose_scaled_kmajor(to_torch(qk), to_torch(sk)), want)


def test_mxfp4_transpose_scaled_validation():
    with pytest.raises(ValueError):                       # K not a multiple of 32
        qt.mxfp4_transpose_scaled_kmajor(torch.zeros(24, 64, dtype=torch.uint8),
                                         torch.zeros(1, 64, dtype=torch.uint8))
    with pytest.raises(ValueError):                       # scales of the wrong shape
        qt.mxfp4_transpose_scaled_kmajor(torch.zeros(32, 64, dtype=torch.uint8),
                                         torch.zeros(2, 63, dtype=torch.uint8))
    with pytest.raises(ValueError):                       # N not a multiple of 32
        qt.mxfp4_transpose_scaled(torch.zeros(64, 24, dtype=torch.uint8),
                                  torch.zeros(64, 2, dtype=torch.uint8))


def test_wrappers_take_cpu_tensors_to_plain_versions():
    """On CPU tensors the K12-K15 wrappers return their plain versions'
    results and launch nothing."""
    from qutlass_tpu_torch.kernels import backward as B
    from qutlass_tpu_torch.ops import dispatch
    x = to_torch(randn_bf16(np.random.default_rng(16), 64, 96, scale=2.0))
    h = qt.hadamard_matrix(32, device="cpu")
    dispatch.reset_launch_counts()
    a = B.backward_t_bf16(x, h, rot_size=32)
    assert all(torch.equal(u, v) for u, v in zip(a, TE.backward_t_bf16(x, h, rot_size=32)))
    xq, xs = qt.fusedQuantizeMx(x, h, method="abs_max")
    b = B.backward_qt_bf16(xq, xs[:64, :3], h, 3.0, rot_size=32)
    assert b[0].shape == (96, 32) and b[1].shape == (96, 2)
    assert B.mxfp4_transpose_scaled(xq, xs[:64, :3]).shape == (96, 64)
    qk, sk = qt.fusedQuantizeMx(x, h, layout="kmajor")
    assert B.mxfp4_transpose_scaled_kmajor(qk, sk).shape == (96, 64)
    assert all(v == 0 for v in dispatch.launch_counts.values())


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

def _natural_order_golden(pkg, mk, x, w, h, gy):
    """tests/test_linear.py:144-158 with package ``pkg``'s ops (``mk``
    turns numpy into its arrays): K-major quantize with the clip mask,
    #14 on both operands, the bf16 contractions, the mask, the
    unrotation.  Returns (dX, dW) as fp32 numpy."""
    xqt, xst, mask_t = pkg.fusedQuantizeMx(mk(x), mk(h), method="quest", return_mask=True,
                                           layout="kmajor")
    wqt, wst = pkg.fusedQuantizeMx(mk(w), mk(h), method="quest", layout="kmajor")
    wdq = pkg.mxfp4_transpose_scaled_kmajor(wqt, wst)          # [K, N] bf16
    xdq = pkg.mxfp4_transpose_scaled_kmajor(xqt, xst)          # [K, M] bf16
    k = x.shape[1]
    if pkg is q:
        g = jnp.asarray(gy)
        dxh = jnp.dot(g, wdq.T, preferred_element_type=jnp.float32).astype(jnp.bfloat16)
        dxh = dxh * JL._unpack_mask_bits(mask_t.T, k).astype(jnp.bfloat16)
        dwh = jnp.dot(g.T, xdq.T, preferred_element_type=jnp.float32).astype(jnp.bfloat16)
        rx, rw = JL._unrotate(dxh, mk(h)), JL._unrotate(dwh, mk(h))
        return np.asarray(rx, np.float32), np.asarray(rw, np.float32)
    g = to_torch(gy)
    dxh = TL._bf16_matmul(g, wdq.T) * TL._unpack_mask_bits(mask_t.T, k).to(torch.bfloat16)
    dwh = TL._bf16_matmul(g.T, xdq.T)
    rx, rw = TL._unrotate(dxh, mk(h)), TL._unrotate(dwh, mk(h))
    return rx.float().numpy(), rw.float().numpy()


@pytest.mark.parametrize("m,n,k", [(64, 128, 256), (96, 160, 384)])
def test_bf16_grad_matches_natural_order_golden(m, n, k):
    """The port's tests/test_linear.py:123-167: quartet_linear's bf16 grad
    mode equals the natural-order construction through the port's #14 to
    that test's rtol 8e-3, atol 1e-4 (the grads carry one more bf16
    rounding); the construction in the two packages within cosine 0.9999
    (bitwise operands, unrotation sums in another order)."""
    rng = np.random.default_rng(2)
    x = randn_bf16(rng, m, k, scale=1.0)
    w = randn_bf16(rng, n, k, scale=0.05)
    gy = rng.standard_normal((m, n)).astype(np.float32).astype(ml_dtypes.bfloat16)
    h = hadamard_np(32)
    tx, tw = to_torch(x).requires_grad_(), to_torch(w).requires_grad_()
    TL.quartet_linear(tx, tw, to_torch(h), "quest", "bf16").backward(to_torch(gy))
    rx, rw = _natural_order_golden(qt, to_torch, x, w, h, gy)
    np.testing.assert_allclose(to_np(tx.grad).astype(np.float32), rx, rtol=8e-3, atol=1e-4)
    np.testing.assert_allclose(to_np(tw.grad).astype(np.float32), rw, rtol=8e-3, atol=1e-4)
    jx, jw = _natural_order_golden(q, jnp.asarray, x, w, h, gy)
    assert cosine(rx, jx) >= 0.9999 and cosine(rw, jw) >= 0.9999


def test_reference_backward_flow_matches_byte_flow():
    """qutlass_tpu/nn/linear.py:6-15 on the CPU: K8's scaled dY, #13 on
    the row-major W and X, bf16 contractions; against the byte-level flow
    (K9, K10, K11) within cosine 0.9999, and #13's operands equal to K10's
    decode bitwise."""
    rng = np.random.default_rng(3)
    m, n, k = 256, 256, 512
    x = to_torch(randn_bf16(rng, m, k, scale=1.0))
    w = to_torch(randn_bf16(rng, n, k, scale=k ** -0.5))
    dy = to_torch(randn_bf16(rng, m, n, scale=1e-3))
    h = qt.hadamard_matrix(32, device="cpu")
    gq = qt.backward_square_double_scaled(dy)
    wq, ws = qt.fusedQuantizeMx(w, h, method="quest")
    xq, xs = qt.fusedQuantizeMx(x, h, method="quest")
    w8, x8 = qt.mxfp4_transpose_scaled(wq, ws), qt.mxfp4_transpose_scaled(xq, xs)
    dxh = TL._bf16_matmul(gq, w8.T)
    dwh = TL._bf16_matmul(gq.T, x8.T)
    g8, g_rs, g_cs = qt.backward_bf16_square_double_mxfp8(dy)
    wb, wbs = qt.mxfp4_transpose_mxfp8(wq, ws)
    xb, xbs = qt.mxfp4_transpose_mxfp8(xq, xs)
    assert _bf16_same(w8, to_np(TE.dequant_fp8(wb, wbs)))
    ref_x = qt.matmul_mxf8_bf16_tn(g8, wb, g_rs, wbs, 1.0)
    ref_w = qt.matmul_mxf8_bf16_nn(g8, xb, g_cs, xbs, 1.0)
    assert cosine(to_np(dxh).astype(np.float32), to_np(ref_x).astype(np.float32)) >= 0.9999
    assert cosine(to_np(dwh).astype(np.float32), to_np(ref_w).astype(np.float32)) >= 0.9999


def test_wgrad_operands_of_the_survey():
    """SURVEY.md 3.4's wgrad operands: backward_t_bf16 of dY and of X
    through the fp4 GEMM give dY^T X, and backward_qt_bf16 (alpha 3) of
    X's abs-max MXFP4 gives dY^T dq(X).  Each operand's codes carry 3x
    (abs-max), so the GEMM's alpha is 1/9; cosine >= 0.95 and a norm
    ratio in [0.9, 1.1] (gross-fault bounds)."""
    rng = np.random.default_rng(4)
    t, d, f = 512, 128, 256                   # tokens, features of X, of dY
    x = to_torch(randn_bf16(rng, t, d, scale=1.0))
    dy = to_torch(randn_bf16(rng, t, f, scale=1e-3))
    h = qt.hadamard_matrix(32, device="cpu")
    a, a_s = qt.backward_t_bf16(dy, h)
    b, b_s = qt.backward_t_bf16(x, h)
    got = qt.matmul_mxf4_bf16_tn(a, b, a_s, b_s, 1.0 / 9.0).float()
    exact = dy.double().T @ x.double()
    xq, xs = qt.fusedQuantizeMx(x, h, method="abs_max")
    bq, bq_s = qt.backward_qt_bf16(xq, xs, h, 3.0)
    got_q = qt.matmul_mxf4_bf16_tn(a, bq, a_s, bq_s, 1.0 / 9.0).float()
    dqx = TE.dequant_fp4(TE.unpack_codes(xq), xs[:t, :d // 32]).double() / 3.0
    exact_q = dy.double().T @ dqx
    for g, e in ((got, exact), (got_q, exact_q)):
        assert cosine(g.numpy(), e.numpy()) >= 0.95
        assert 0.9 <= float(g.double().norm() / e.norm()) <= 1.1
