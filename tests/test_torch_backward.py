"""The port's QAT backward ops (plain versions of kernels K8-K11, reached
through the public ops on CPU tensors) fed the same inputs as the JAX
package, its Pallas kernels in interpret mode, and the fp64 golden.

Tolerances: K8-K10 bitwise, with one exception.  A 32x32 tile whose
shared exponent byte is 0 has the scale 2^-127, an fp32 subnormal, and
XLA:CPU flushes subnormals to zero: the JAX package's CPU run divides by
zero there and saturates, while PyTorch and the CUDA kernels keep the
subnormal.  Such tiles are held to the fp64 golden alone.  K11 (an fp64
sum of exact bf16 products) within a 1e-3 bf16 mismatch rate and 1 ulp
of the JAX package's fp32-accumulating GEMM, and within the reference's
1e-1 budget of fp64.
"""
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import qutlass_tpu as q
import qutlass_tpu_torch as qt
from qutlass_tpu.formats import codecs as JC
from qutlass_tpu.formats import golden as G
from qutlass_tpu.kernels import backward as KB
from qutlass_tpu.ops import emulation as JE
from qutlass_tpu_torch.formats import codecs as TC
from qutlass_tpu_torch.ops import emulation as TE
from torch_helpers import cosine, hadamard_np, randn_bf16, to_np, to_torch

PKG = Path(__file__).resolve().parent.parent / "qutlass_tpu_torch"


def _u16(y) -> np.ndarray:
    y = to_np(y) if isinstance(y, torch.Tensor) else np.asarray(y)
    return y.view(np.uint16)


def _bf16_same(got, want) -> bool:
    """bf16 bit patterns equal, a NaN matching any NaN (PyTorch's CPU cast
    of a NaN to bf16 sets the sign bit, XLA's does not)."""
    g = to_np(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    gn, wn = np.isnan(g.astype(np.float32)), np.isnan(w.astype(np.float32))
    return bool(np.array_equal(gn, wn)) and bool(
        np.array_equal(g.view(np.uint16)[~gn], w.view(np.uint16)[~wn]))


def _ulps(got, want):
    a = _u16(got).astype(np.int32)
    b = _u16(want).astype(np.int32)
    a = np.where(a >= 0x8000, 0x8000 - a, a)        # sign-magnitude -> ordered ints
    b = np.where(b >= 0x8000, 0x8000 - b, b)
    return float((a != b).mean()), int(np.abs(a - b).max())


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("half", [0, 1])
def test_e4m3_decode_scaled_bf16_sweep(half):
    """Every e4m3 byte under every e8m0 scale byte, bitwise."""
    b = np.repeat(np.arange(128 * half, 128 * (half + 1)), 256).astype(np.int32)
    s = np.tile(np.arange(256), 128).astype(np.int32)
    want = np.asarray(JC.e4m3_decode_scaled_bf16(jnp.asarray(b), jnp.asarray(s)))
    got = TC.e4m3_decode_scaled_bf16(torch.tensor(b), torch.tensor(s))
    np.testing.assert_array_equal(_u16(got), want.view(np.uint16))


_AMAX = {
    "zero": np.zeros(4, np.float32),
    "pow2": 2.0 ** np.arange(-126, 128, dtype=np.float64),
    "pow2_minus_ulp": np.nextafter(2.0 ** np.arange(-125, 128, dtype=np.float32),
                                   np.float32(0)),
    "random": np.random.default_rng(0).lognormal(0, 20, 4096),
    "edges": np.array([2.0 ** -119.5, 1.5 * 2.0 ** -121, 2.0 ** -123, np.inf, np.nan]),
}


@pytest.mark.parametrize("kind", sorted(_AMAX))
def test_mxfp8_shared_exp_bytes(kind):
    am = np.asarray(_AMAX[kind], np.float32)
    want = np.asarray(JC.mxfp8_shared_exp_bytes(jnp.asarray(am)))
    got = TC.mxfp8_shared_exp_bytes(torch.tensor(am)).numpy()
    np.testing.assert_array_equal(got, want)


def test_mxfp8_shared_exp_bytes_subnormal_amax():
    """An fp32-subnormal amax: the pow2 floor of its bits is byte 0, so
    the shared exponent wraps to 249 (XLA:CPU reads the subnormal as 0
    and gives 127)."""
    am = torch.tensor([1e-40, 2.0 ** -130], dtype=torch.float32)
    assert TC.mxfp8_shared_exp_bytes(am).tolist() == [249, 249]


# ---------------------------------------------------------------------------
# K8 / K9: square-double MXFP8
# ---------------------------------------------------------------------------

SD_CASES = [((256, 512), 1.0), ((128, 96), 8.0), ((422, 256), 5.0), ((32, 32), 300.0),
            ((100, 64), 1e-3)]


@pytest.mark.parametrize("shape,scale", SD_CASES)
def test_square_double_vs_jax(shape, scale):
    x = randn_bf16(np.random.default_rng(1), *shape, scale=scale)
    want = q.backward_bf16_square_double_mxfp8(jnp.asarray(x))
    got = qt.backward_bf16_square_double_mxfp8(to_torch(x))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert _bf16_same(qt.backward_square_double_scaled(to_torch(x)),
                      q.backward_square_double_scaled(jnp.asarray(x)))


@pytest.mark.parametrize("shape,scale", SD_CASES)
def test_square_double_vs_golden(shape, scale):
    x = randn_bf16(np.random.default_rng(2), *shape, scale=scale)
    mp = -(-shape[0] // 128) * 128
    xp = np.zeros((mp, shape[1]), ml_dtypes.bfloat16)
    xp[:shape[0]] = x
    fp8, rows, cols = G.bf16_square_double_mxfp8(xp)
    got = qt.backward_bf16_square_double_mxfp8(to_torch(x))
    for g, w in zip(got, (fp8, rows, cols)):
        np.testing.assert_array_equal(g.numpy(), w)
    # the scaled twin decodes the same bytes
    want = (G.e4m3_to_f64(fp8) * np.repeat(G.e8m0_to_f64(rows), 32, axis=1)
            ).astype(ml_dtypes.bfloat16)
    assert _bf16_same(qt.backward_square_double_scaled(to_torch(x)), want)


@pytest.mark.parametrize("shape", [(256, 64), (512, 96)])
def test_square_double_pallas_interpret(shape):
    """TPU kernels #11 and #12 run in interpret mode equal the port."""
    x = randn_bf16(np.random.default_rng(3), *shape, scale=4.0)
    with pltpu.force_tpu_interpret_mode():
        want = KB.backward_bf16_square_double_mxfp8_2d(jnp.asarray(x))
        want_s = KB.backward_square_double_scaled_2d(jnp.asarray(x))
    got = TE.backward_bf16_square_double_mxfp8(to_torch(x))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert _bf16_same(TE.backward_square_double_scaled(to_torch(x)), want_s)


def _edge_tiles():
    """[128, 96] bf16 whose tiles reach the shared exponent's edges: amax
    0 (byte 127), in [2^-120, 2^-119) (byte 0), in [2^-121, 2^-120)
    (byte 255, a NaN scale), 2^-123 (wraps to 253: quantizes to 0), and
    normal tiles; returns (x, the byte-0 tile's row/col slices)."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((128, 96)) * 3.0).astype(np.float32)
    u = rng.uniform(-1, 1, (32, 32))
    x[0:32, 0:32] = 0.0
    x[32:64, 0:32] = u * 2.0 ** -119.5
    x[32, 0] = 1.5 * 2.0 ** -120
    x[64:96, 0:32] = u * 2.0 ** -120.5
    x[64, 1] = 1.5 * 2.0 ** -121
    x[96:128, 0:32] = u * 2.0 ** -123
    return x.astype(ml_dtypes.bfloat16), (slice(32, 64), slice(0, 32))


def test_square_double_edge_tiles():
    x, (r0, c0) = _edge_tiles()
    fp8, rows, cols = qt.backward_bf16_square_double_mxfp8(to_torch(x))
    gf, gr, gc = G.bf16_square_double_mxfp8(x)
    assert rows[32:64:32, 0].tolist() == [0] and rows[64, 0] == 255 and rows[96, 0] == 253
    assert rows[0, 0] == 127
    # the fp64 golden: every tile, the byte-0 tile's subnormal scale included
    np.testing.assert_array_equal(rows.numpy(), gr)
    np.testing.assert_array_equal(cols.numpy(), gc)
    np.testing.assert_array_equal(fp8.numpy(), gf)
    assert ((fp8.numpy()[96:128, :32] & 0x7F) == 0).all()       # +-0
    assert (fp8.numpy()[64:96, :32] == 0x7F).all()               # NaN
    # the JAX package on every tile but the byte-0 one (XLA:CPU flushes
    # its 2^-127 scale to zero)
    jf, jr, jc = (np.asarray(t) for t in q.backward_bf16_square_double_mxfp8(jnp.asarray(x)))
    np.testing.assert_array_equal(rows.numpy(), jr)
    keep = np.ones(fp8.shape, bool)
    keep[r0, c0] = False
    np.testing.assert_array_equal(fp8.numpy()[keep], jf[keep])
    s = to_np(qt.backward_square_double_scaled(to_torch(x))).astype(np.float32)
    js = np.asarray(q.backward_square_double_scaled(jnp.asarray(x))).astype(np.float32)
    np.testing.assert_array_equal(np.isnan(s)[keep], np.isnan(js)[keep])
    np.testing.assert_array_equal(np.nan_to_num(s)[keep], np.nan_to_num(js)[keep])
    # the byte-0 tile decodes to the tile's values rounded to e4m3 (x 2^-127)
    want = (G.e4m3_to_f64(gf[r0, c0]) * 2.0 ** -127).astype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(_u16(to_torch(want)), to_np(
        qt.backward_square_double_scaled(to_torch(x)))[r0, c0].view(np.uint16))


def test_square_double_inf_nan_tiles():
    """An inf makes its tile's exponent 248 and saturates to +-448; a NaN
    makes the tile's maximum NaN (exponent 127) and quantizes to 0x7F;
    as the JAX package computes them."""
    x = (np.random.default_rng(5).standard_normal((128, 64)) * 2.0).astype(np.float32)
    x[0, 40] = np.inf
    x[40, 10] = np.nan
    xb = x.astype(ml_dtypes.bfloat16)
    got = qt.backward_bf16_square_double_mxfp8(to_torch(xb))
    want = q.backward_bf16_square_double_mxfp8(jnp.asarray(xb))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1][0, 1] == 248 and got[1][40, 0] == 127 and got[0][40, 10] == 0x7F
    assert _bf16_same(qt.backward_square_double_scaled(to_torch(xb)),
                      q.backward_square_double_scaled(jnp.asarray(xb)))


def test_square_double_validation():
    with pytest.raises(TypeError):
        qt.backward_bf16_square_double_mxfp8(torch.zeros(32, 32))
    with pytest.raises(ValueError):
        qt.backward_square_double_scaled(torch.zeros(32, 48, dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# K10: MXFP4 -> transpose -> MXFP8
# ---------------------------------------------------------------------------

def _fp4(m, n, method, seed, rot=32):
    h = jnp.asarray(hadamard_np(rot))
    x = jnp.asarray(randn_bf16(np.random.default_rng(seed), m, n, scale=5.0))
    xq, xs = q.fusedQuantizeMx(x, h, method=method)
    return np.asarray(xq), np.asarray(xs)


@pytest.mark.parametrize("m,n", [(256, 256), (422, 256), (96, 512), (512, 128)])
@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_mxfp4_transpose_mxfp8_vs_jax(m, n, method):
    """The public op on the quantizer's padded scale buffer, M padded to
    256 under unit scales, bitwise."""
    xq, xs = _fp4(m, n, method, 6)
    want = q.mxfp4_transpose_mxfp8(jnp.asarray(xq), jnp.asarray(xs))
    got = qt.mxfp4_transpose_mxfp8(to_torch(xq), to_torch(xs))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].shape == (n, -(-m // 256) * 256)


@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_mxfp4_transpose_mxfp8_pallas_interpret(method):
    """TPU kernel #15 in interpret mode equals the port."""
    xq, xs = _fp4(256, 512, method, 7)
    xs = xs[:256, :16]
    with pltpu.force_tpu_interpret_mode():
        want = KB.mxfp4_transpose_mxfp8_2d(jnp.asarray(xq), jnp.asarray(xs))
    got = TE.mxfp4_transpose_mxfp8(to_torch(xq), to_torch(xs))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_mxfp4_transpose_mxfp8_vs_oracle():
    """tests/test_quartet.py's fp64 oracle: shared exponents exact, e4m3
    bytes equal."""
    m, n = 300, 256
    xq, xs = _fp4(m, n, "abs_max", 8, rot=16)
    fp8, sexps = qt.mxfp4_transpose_mxfp8(to_torch(xq), to_torch(xs))
    xp = np.zeros((512, n // 2), np.uint8)
    xp[:m] = xq
    sp = np.full((512, n // 32), 127, np.uint8)
    sp[:m] = xs[:m, :n // 32]
    g = G.dq_fp4(xp, sp, 32, 1.0).T.reshape(n, 512 // 32, 32)
    amax = np.abs(g).max(-1)
    with np.errstate(divide="ignore"):
        ref_e = np.where(amax > 0, np.floor(np.log2(np.where(amax > 0, amax, 1.0))) + 120,
                         127).astype(np.uint8)
    np.testing.assert_array_equal(sexps.numpy(), ref_e)
    q8 = (g / G.e8m0_to_f64(ref_e)[..., None]).astype(ml_dtypes.bfloat16).astype(
        ml_dtypes.float8_e4m3fn)
    np.testing.assert_array_equal(fp8.numpy(), q8.view(np.uint8).reshape(n, 512))


def test_mxfp4_transpose_mxfp8_every_scale_byte():
    """Scale bytes 0..255 (0 and 255 included) and random codes, bitwise
    against the JAX emulation except groups that meet XLA:CPU's flush of
    subnormals (a decoded value or a shared scale below 2^-126)."""
    rng = np.random.default_rng(9)
    m, n = 256, 2048
    xq = rng.integers(0, 256, (m, n // 2), dtype=np.uint8)
    xs = (np.arange(m * n // 32) % 256).astype(np.uint8).reshape(m, n // 32)
    got = TE.mxfp4_transpose_mxfp8(to_torch(xq), to_torch(xs))
    want = JE.mxfp4_transpose_mxfp8(jnp.asarray(xq), jnp.asarray(xs))
    dq = G.dq_fp4(xq, xs, 32, 1.0).T                    # [N, M] fp64
    g = np.abs(dq).reshape(n, m // 32, 32)
    with np.errstate(invalid="ignore"):
        flushed = ((g > 0) & (g < 2.0 ** -126)).any(-1) | (
            (g.max(-1) >= 2.0 ** -120) & (g.max(-1) < 2.0 ** -119))
    keep_g = ~flushed
    np.testing.assert_array_equal(got[1].numpy()[keep_g], np.asarray(want[1])[keep_g])
    keep = np.repeat(keep_g, 32, axis=1)
    np.testing.assert_array_equal(got[0].numpy()[keep], np.asarray(want[0])[keep])
    assert keep_g.mean() > 0.9


# ---------------------------------------------------------------------------
# K11: the MXFP8 GEMM
# ---------------------------------------------------------------------------

def _pseudoquant_mxfp8(x64: np.ndarray):
    """tests/test_mxfp8.py's golden MXFP8 quantizer: (dq, e4m3, e8m0)."""
    orig = x64.shape
    x = x64.reshape(-1, 32)
    absmax = np.abs(x).max(axis=-1, keepdims=True)
    with np.errstate(divide="ignore"):
        e = np.where(absmax > 0,
                     np.floor(np.log2(np.where(absmax > 0, absmax, 1.0))) - 8 + 128,
                     128).astype(np.uint8)
    sc = np.ldexp(1.0, e.astype(np.int64) - 127)
    xq = np.clip(x / sc, -448.0, 448.0).astype(ml_dtypes.bfloat16).astype(
        ml_dtypes.float8_e4m3fn)
    return ((xq.astype(np.float64) * sc).reshape(orig), xq.view(np.uint8).reshape(orig),
            e.reshape(orig[:-1] + (orig[-1] // 32,)))


@pytest.mark.parametrize("shape", [(16, 512, 4096), (16, 384, 10752), (7, 256, 5120),
                                   (96, 160, 1024)])
@pytest.mark.parametrize("layout", ["tn", "nn"])
def test_matmul_mxf8_vs_jax_and_fp64(shape, layout):
    rng = np.random.default_rng(0)
    m, n, k = shape
    a64 = (rng.standard_normal((m, k)) * 25.0).astype(ml_dtypes.bfloat16).astype(np.float64)
    b64 = (rng.standard_normal((n, k)) * 25.0).astype(ml_dtypes.bfloat16).astype(np.float64)
    a_dq, a8, ae = _pseudoquant_mxfp8(a64)
    b_dq, b8, be = _pseudoquant_mxfp8(b64)
    al = np.array([0.75], np.float32)
    if layout == "tn":
        want = q.matmul_mxf8_bf16_tn(jnp.asarray(a8), jnp.asarray(b8), jnp.asarray(ae),
                                     jnp.asarray(be), jnp.asarray(al))
        got = qt.matmul_mxf8_bf16_tn(to_torch(a8), to_torch(b8), to_torch(ae),
                                     to_torch(be), to_torch(al))
    else:
        at = np.ascontiguousarray(a8.T)
        want = q.matmul_mxf8_bf16_nn(jnp.asarray(at), jnp.asarray(b8), jnp.asarray(ae),
                                     jnp.asarray(be), jnp.asarray(al))
        got = qt.matmul_mxf8_bf16_nn(to_torch(at), to_torch(b8), to_torch(ae),
                                     to_torch(be), to_torch(al))
    rate, ulps = _ulps(got, want)
    assert rate <= 1e-3 and ulps <= 1, (rate, ulps)
    ref = (a_dq @ b_dq.T * 0.75).astype(np.float32)
    np.testing.assert_allclose(to_np(got).astype(np.float32), ref, rtol=1e-1, atol=1e-1)
    # the plain version is bf16(fp32(fp64 sum) * alpha): exactly that here
    np.testing.assert_array_equal(
        _u16(got), ((a_dq @ b_dq.T).astype(np.float32) * np.float32(0.75)
                    ).astype(ml_dtypes.bfloat16).view(np.uint16))


def test_matmul_mxf8_unit_scales_bitwise():
    """tests/test_mxfp8.py: with unit scales the GEMM is exact against fp64."""
    rng = np.random.default_rng(0)
    m, n, k = 384, 256, 512
    a8 = rng.standard_normal((m, k)).astype(ml_dtypes.bfloat16).astype(ml_dtypes.float8_e4m3fn)
    b8 = rng.standard_normal((n, k)).astype(ml_dtypes.bfloat16).astype(ml_dtypes.float8_e4m3fn)
    ones = np.full((m, k // 32), 127, np.uint8)
    onesb = np.full((n, k // 32), 127, np.uint8)
    got = qt.matmul_mxf8_bf16_tn(to_torch(a8.view(np.uint8)), to_torch(b8.view(np.uint8)),
                                 to_torch(ones), to_torch(onesb), 1.0)
    ref = (a8.astype(np.float64) @ b8.astype(np.float64).T).astype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(_u16(got), ref.view(np.uint16))


def test_matmul_mxf8_scale_layouts():
    """Scales as the exact matrix, a padded 2-D buffer, its flattening,
    or float8 views give the same result; bad shapes raise."""
    rng = np.random.default_rng(10)
    m, n, k = 40, 24, 256
    a = to_torch(rng.integers(0, 0x7E, (m, k), dtype=np.uint8))
    b = to_torch(rng.integers(0, 0x7E, (n, k), dtype=np.uint8))
    sa = to_torch(rng.integers(120, 134, (m, k // 32), dtype=np.uint8))
    sb = to_torch(rng.integers(120, 134, (n, k // 32), dtype=np.uint8))
    want = qt.matmul_mxf8_bf16_tn(a, b, sa, sb, 1.0)
    pa = torch.full((128, 8), 7, dtype=torch.uint8)
    pa[:m, :k // 32] = sa
    assert torch.equal(qt.matmul_mxf8_bf16_tn(a, b, pa, qt.to_blocked(sb), 1.0), want)
    assert torch.equal(qt.matmul_mxf8_bf16_tn(a.view(torch.float8_e4m3fn), b,
                                              sa.view(torch.float8_e8m0fnu), sb, 1.0), want)
    assert torch.equal(qt.matmul_mxf8_bf16_nn(a.T.contiguous(), b, sa, sb, 1.0), want)
    with pytest.raises(ValueError):
        qt.matmul_mxf8_bf16_tn(a[:, :48], b[:, :48], sa, sb, 1.0)
    with pytest.raises(ValueError):
        qt.matmul_mxf8_bf16_tn(a, b[:, :128], sa, sb, 1.0)


# ---------------------------------------------------------------------------
# the reference's byte-level backward flow (tests/test_quartet.py:121-143)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n", [(422, 256), (256, 512)])
def test_backward_flow_nn_gemm(m, n):
    """Square-double dY, transpose-requantize an MXFP4 operand, the NN
    GEMM: the same bytes as the JAX package at each step, and the result
    within cosine 0.99 of the fp64 product."""
    x64 = randn_bf16(np.random.default_rng(0), m, n, scale=5.0)
    eye = np.eye(32).astype(ml_dtypes.bfloat16)
    ja8, jar, jac = q.backward_bf16_square_double_mxfp8(jnp.asarray(x64))
    jfq, jfs = q.fusedQuantizeMx(jnp.asarray(x64), jnp.asarray(eye), method="abs_max")
    jb8, jbe = q.mxfp4_transpose_mxfp8(jfq, jfs)
    jout = q.matmul_mxf8_bf16_nn(ja8, jb8, jac, jbe, jnp.asarray([1.0], jnp.float32))

    a8, ar, ac = qt.backward_bf16_square_double_mxfp8(to_torch(x64))
    fq, fs = qt.fusedQuantizeMx(to_torch(x64), to_torch(eye), method="abs_max")
    b8, be = qt.mxfp4_transpose_mxfp8(fq, fs)
    out = qt.matmul_mxf8_bf16_nn(a8, b8, ac, be, 1.0)
    for g, w in ((a8, ja8), (ac, jac), (b8, jb8), (be, jbe)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    rate, ulps = _ulps(out, jout)
    assert rate <= 1e-3 and ulps <= 1, (rate, ulps)
    ref = x64.astype(np.float64).T @ x64.astype(np.float64)
    assert cosine(to_np(out).astype(np.float32), ref) > 0.99


# ---------------------------------------------------------------------------
# the package boundary
# ---------------------------------------------------------------------------

def test_qat_modules_import_no_jax():
    """The QAT modules and the backward-operand ops import neither JAX nor
    the JAX package (a clean process)."""
    code = ("import sys, qutlass_tpu_torch, qutlass_tpu_torch.kernels.backward, "
            "qutlass_tpu_torch.nn.linear, qutlass_tpu_torch.models.convert; "
            "from qutlass_tpu_torch.nn import QuartetLinear, quartet_linear; "
            "from qutlass_tpu_torch import (backward_t_bf16, backward_qt_bf16, "
            "mxfp4_transpose_scaled, mxfp4_transpose_scaled_kmajor); "
            "from qutlass_tpu_torch.kernels.backward import (backward_t_bf16, "
            "backward_qt_bf16, mxfp4_transpose_scaled, mxfp4_transpose_scaled_kmajor); "
            "bad = [m for m in sys.modules if m in ('jax', 'qutlass_tpu') or "
            "m.startswith(('jax.', 'qutlass_tpu.'))]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=PKG.parent, timeout=120)


def test_kernel_wrappers_take_cpu_tensors_to_plain_versions():
    """On CPU tensors the K8-K11 wrappers return their plain versions'
    results and launch nothing."""
    from qutlass_tpu_torch.kernels import backward as B
    from qutlass_tpu_torch.kernels import gemm as KG
    from qutlass_tpu_torch.ops import dispatch
    x = to_torch(randn_bf16(np.random.default_rng(11), 64, 96, scale=2.0))
    dispatch.reset_launch_counts()
    f, e = B.square_double_mxfp8(x)
    assert torch.equal(f, TE.square_double_tiles(x)[0]) and e.shape == (2, 3)
    assert torch.equal(B.square_double_scaled(x).view(torch.int16),
                       TE.backward_square_double_scaled(x).view(torch.int16))
    xq, xs = qt.fusedQuantizeMx(x, qt.hadamard_matrix(32, device="cpu"))
    t8, te = B.mxfp4_transpose_mxfp8(xq, xs[:64, :3])
    assert t8.shape == (96, 64) and te.shape == (96, 2)
    y = KG.gemm_fp8_mx(f, f, e.repeat_interleave(32, 0), e.repeat_interleave(32, 0), 1.0,
                       layout="tn")
    assert y.shape == (64, 64)
    assert all(v == 0 for v in dispatch.launch_counts.values())
