"""The port's GEMMs (plain versions of kernels K3 and K4, reached through
the public ops on CPU tensors) fed the same bytes as the JAX package.

Tolerances: bitwise.  The fp4 GEMMs must equal JAX's and bf16(fp64
dequant matmul); the int8 evaluator must equal JAX's, and equal the fp4
GEMM whenever the max deficit is <= 3.
"""
import numpy as np
import ml_dtypes
import jax.numpy as jnp
import pytest
import torch

import qutlass_tpu as q
import qutlass_tpu_torch as qt
from qutlass_tpu.formats import golden as G
from qutlass_tpu.ops import int8path as JI8
from qutlass_tpu_torch.ops import int8path as TI8
from torch_helpers import hadamard_np, randn_bf16, to_np, to_torch


def _bits(y) -> np.ndarray:
    y = to_np(y) if isinstance(y, torch.Tensor) else np.asarray(y)
    return y.view(np.uint16)


def _operands(m, n, k, method="quest", seed=0, layout="kmajor"):
    """JAX-quantized operands (numpy bytes) for both packages."""
    rng = np.random.default_rng(seed)
    h = jnp.asarray(hadamard_np(32))
    xa = jnp.asarray(randn_bf16(rng, m, k))
    xb = jnp.asarray(randn_bf16(rng, n, k))
    a = q.fusedQuantizeMx(xa, h, method=method, layout=layout)
    b = q.fusedQuantizeMx(xb, h, method=method, layout=layout)
    return [np.asarray(t) for t in (*a, *b)]


def _golden(a_rowmajor, b_rowmajor, as_, bs_, alpha) -> np.ndarray:
    da = G.dq_fp4(a_rowmajor, as_, 32, 1.0)
    db = G.dq_fp4(b_rowmajor, bs_, 32, 1.0)
    return (da @ db.T * alpha).astype(ml_dtypes.bfloat16).view(np.uint16)


@pytest.mark.parametrize("m,n,k", [(4, 96, 256), (40, 64, 512), (130, 72, 1024)])
@pytest.mark.parametrize("alpha", [1.0, 0.375])
def test_matmul_mxf4_tn_bitwise(m, n, k, alpha):
    a, as_, b, bs_ = _operands(m, n, k, layout="rowmajor")
    al = np.array([alpha], np.float32)
    want = q.matmul_mxf4_bf16_tn(jnp.asarray(a), jnp.asarray(b),
                                 q.to_blocked(jnp.asarray(as_)),
                                 q.to_blocked(jnp.asarray(bs_)), jnp.asarray(al))
    got = qt.matmul_mxf4_bf16_tn(to_torch(a), to_torch(b),
                                 qt.to_blocked(to_torch(as_)),
                                 qt.to_blocked(to_torch(bs_)), to_torch(al))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(
        _bits(got), _golden(a, b, as_[:m, :k // 32], bs_[:n, :k // 32], alpha))
    # the ada alias and float8_e8m0fnu scale views take the same path
    got2 = qt.matmul_ada_mxf4_bf16_tn(
        to_torch(a), to_torch(b), to_torch(as_).view(torch.float8_e8m0fnu),
        to_torch(bs_), alpha)
    np.testing.assert_array_equal(_bits(got2), _bits(want))


@pytest.mark.parametrize("variant", ["kmajor", "kmajor_codes"])
def test_matmul_mxf4_kmajor_bitwise(variant):
    m, n, k = 12, 80, 512
    a, as_, _, _ = _operands(m, n, k, layout=variant)
    _, _, b, bs_ = _operands(m, n, k, layout="kmajor")
    al = np.array([1.0], np.float32)
    fn_j = getattr(q, f"matmul_mxf4_bf16_{variant}")
    fn_t = getattr(qt, f"matmul_mxf4_bf16_{variant}")
    want = fn_j(*(jnp.asarray(t) for t in (a, b, as_, bs_, al)))
    got = fn_t(*(to_torch(t) for t in (a, b, as_, bs_, al)))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("method", ["quest", "abs_max"])
@pytest.mark.parametrize("m,n,k", [(4, 64, 512), (33, 96, 1024)])
def test_int8_kmajor_bitwise_and_equal_to_fp4(method, m, n, k):
    xqt, xst, wqt, wst = _operands(m, n, k, method=method, seed=3)
    alpha = 1.0 if method == "quest" else 1.0 / 9.0
    # JAX: activation through the fused int8 quantizer's composition,
    # weight through prepare_weight_int8
    ja, jsa, _ = JI8.encode_int8(jnp.asarray(xqt), jnp.asarray(xst), kmajor=True)
    jw, jsb, jd = JI8.prepare_weight_int8(jnp.asarray(wqt), jnp.asarray(wst))
    want = JI8.matmul_mxf4_bf16_int8_kmajor(ja, jw, jsa, jsb, jnp.float32(alpha))
    ta, tsa, td_a = TI8.encode_int8(to_torch(xqt), to_torch(xst), kmajor=True)
    tw, tsb, td = TI8.prepare_weight_int8(to_torch(wqt), to_torch(wst))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tsb.numpy(), np.asarray(jsb))
    assert int(td) == int(jd)
    got = TI8.matmul_mxf4_bf16_int8_kmajor(ta, tw, tsa, tsb, alpha)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert max(int(td), int(td_a)) <= 3
    fp4 = qt.matmul_mxf4_bf16_kmajor(to_torch(xqt), to_torch(wqt), to_torch(xst),
                                     to_torch(wst), alpha)
    np.testing.assert_array_equal(_bits(got), _bits(fp4))


def test_int8_variants_agree():
    """Row-major, K-major and both-K-major operand orders give one result."""
    xqt, xst, wqt, wst = _operands(20, 48, 512, seed=4)
    a_k, sa, _ = TI8.encode_int8(to_torch(xqt), to_torch(xst), kmajor=True)
    b_k, sb, _ = TI8.encode_int8(to_torch(wqt), to_torch(wst), kmajor=True)
    ref = TI8.matmul_mxf4_bf16_int8_kmajor(a_k, b_k.T.contiguous(), sa, sb, 0.5)
    kk = TI8.matmul_mxf4_bf16_int8_kk(a_k, b_k, sa, sb, 0.5)
    rm = TI8.matmul_mxf4_bf16_int8(a_k.T.contiguous(), b_k.T.contiguous(), sa, sb,
                                   0.5)
    want = JI8.matmul_mxf4_bf16_int8_kk(jnp.asarray(a_k.numpy()),
                                        jnp.asarray(b_k.numpy()),
                                        jnp.asarray(sa.numpy()),
                                        jnp.asarray(sb.numpy()), jnp.float32(0.5))
    for y in (kk, rm):
        np.testing.assert_array_equal(_bits(y), _bits(ref))
    np.testing.assert_array_equal(_bits(ref), _bits(want))


def test_encode_int8_rowmajor_and_planes_match_jax():
    a, as_, _, _ = _operands(24, 8, 512, layout="rowmajor", seed=5)
    sc = as_[:24, :16]
    want = JI8.encode_int8(jnp.asarray(a), jnp.asarray(sc))
    got = TI8.encode_int8(to_torch(a), to_torch(sc))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    xqt, xst, _, _ = _operands(24, 8, 512, seed=5)
    want = JI8.encode_int8_planes(jnp.asarray(xqt), jnp.asarray(xst))
    got = TI8.encode_int8_planes(to_torch(xqt), to_torch(xst))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_norm_scales_layouts():
    sf = torch.arange(128 * 8, dtype=torch.uint8).reshape(128, 8)
    exact = sf[:5, :6]
    for arg in (sf, qt.to_blocked(sf), exact, exact.to(torch.int32)):
        np.testing.assert_array_equal(qt._norm_scales(arg, 5, 6).numpy(),
                                      exact.numpy())
    with pytest.raises(ValueError):
        qt._norm_scales(torch.zeros(7, dtype=torch.uint8), 5, 6)
    with pytest.raises(TypeError):
        qt._as_bytes(torch.zeros(3, dtype=torch.float16))


def test_layout_helpers_match_jax():
    x = np.arange(5 * 70, dtype=np.int32).reshape(5, 70)
    np.testing.assert_array_equal(qt.pad_to_block(torch.from_numpy(x), [0, 1], 32).numpy(),
                                  np.asarray(q.pad_to_block(jnp.asarray(x), [0, 1], 32)))
    sf = np.arange(128 * 8, dtype=np.uint8).reshape(128, 8)
    np.testing.assert_array_equal(qt.from_blocked(qt.to_blocked(torch.from_numpy(sf)),
                                                  256, 32).numpy(), sf)
    for n in (16, 128):
        np.testing.assert_array_equal(to_np(qt.hadamard_matrix(n, device="cpu")).view(np.uint16),
                                      np.asarray(q.hadamard_matrix(n)).view(np.uint16))
        np.testing.assert_array_equal(to_np(qt.identity_matrix(n, device="cpu")).view(np.uint16),
                                      np.asarray(q.identity_matrix(n)).view(np.uint16))
    with pytest.raises(ValueError):
        qt.hadamard_matrix(24, device="cpu")
