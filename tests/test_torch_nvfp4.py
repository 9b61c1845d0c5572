"""The port's NVFP4 ops (plain versions of kernels K5, K6 and K7, reached
through the public ops on CPU tensors) against the JAX package and the
fp64 golden model, plus the NV linear and the entry points' default
device.

Tolerances, each restated in its test:
  * e4m3 codecs and NV scale cores: bitwise.
  * fusedQuantizeNv: scale bytes and codes equal JAX's at a mismatch rate
    <= 1e-4 (the two frameworks sum the rotation in different orders);
    against the fp64 golden, the budgets of tests/test_nvfp4.py (2e-2
    scale bytes, 1e-1 dequant values).
  * int8 encodes and the NVFP4 GEMM given the same bytes: bitwise; at
    decode row counts also the K-major form and a model of the decode
    kernel's split-K order of sums; the group fold (the prefill kernel's
    arithmetic) against JAX and the fp64 product, and against a model of
    the fp4 tile's order on scale bytes whose fp64 sums round (NaN
    positions aside).
  * NV linear against JAX's ``_linear``: cosine > 0.999; output norm
    within 0.8-1.25 of x @ w.T.
"""
import numpy as np
import jax
import jax.numpy as jnp
import ml_dtypes
import pytest
import torch

import qutlass_tpu as q
import qutlass_tpu_torch as qt
from qutlass_tpu.formats import codecs as JC
from qutlass_tpu.formats import golden as G
from qutlass_tpu.ops import int8path as JI
from qutlass_tpu_torch import models as M
from qutlass_tpu_torch import utils
from qutlass_tpu_torch.formats import codecs as C
from qutlass_tpu_torch.models import convert, serving
from qutlass_tpu_torch.kernels import gemm as KG
from qutlass_tpu_torch.nn import QuantizedLinear, nv_linear, quantize_weight
from qutlass_tpu_torch.ops import dispatch
from qutlass_tpu_torch.ops import emulation as E
from qutlass_tpu_torch.ops import int8path as I8
from torch_helpers import (cosine, hadamard_np, nan_equal, nv_adversarial, randn_bf16, to_np,
                           to_torch)

BUDGET = 1e-4
ROTS = [16, 32, 64, 128]


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

def test_e4m3_decode_all_bytes_bitwise():
    """All 256 bytes decode to JAX's fp32 bits (NaN included)."""
    b = np.arange(256, dtype=np.int32)
    want = np.asarray(JC.e4m3_decode_f32(jnp.asarray(b)))
    got = C.e4m3_decode_f32(torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _e4m3_sweep() -> np.ndarray:
    """A dense fp32 sweep over the e4m3 range and beyond (every 61st bit
    pattern up to 2^10, the subnormal grid and its midpoints, +-448 and
    the values that saturate to it), both signs, plus +-0, +-inf, NaN."""
    dense = np.arange(0, 0x44800000, 61, dtype=np.int64).astype(np.int32).view(np.float32)
    grid = np.arange(0, 1024, dtype=np.float32) * np.float32(2.0 ** -10)
    special = np.array([448, 449, 464, 479.9, 480, 500, 1e30, np.inf, 2.0 ** -6,
                        2.0 ** -7, 2.0 ** -9, 2.0 ** -10, 3 * 2.0 ** -11, 0.0],
                       np.float32)
    x = np.concatenate([dense, grid, special])
    return np.concatenate([x, -x, np.array([np.nan, -np.nan], np.float32)])


@pytest.mark.parametrize("fn", ["e4m3_rtne_bytes", "e4m3_rtne_value_f32"])
def test_e4m3_encode_dense_sweep_bitwise(fn):
    """Bytes and rounded values equal JAX's on every input of the sweep:
    saturation to +-448, subnormals, signed zeros and NaN (byte 0x7F with
    the NaN's sign)."""
    x = _e4m3_sweep()
    want = np.asarray(getattr(JC, fn)(jnp.asarray(x)))
    got = getattr(C, fn)(torch.from_numpy(x)).numpy()
    if fn == "e4m3_rtne_bytes":
        np.testing.assert_array_equal(got, want)
        assert got[x == np.float32(449)][0] == 0x7E      # saturates to 448
    else:
        np.testing.assert_array_equal(_bits(got)[~np.isnan(got)],
                                      _bits(want)[~np.isnan(want)])
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


def test_nv_scale_cores_bitwise():
    """nv_scale_quest, nv_absmax_scale_bytes and nv_quest_scale_bytes
    equal JAX's bit for bit, including negative variances (the NaN that
    zeroes its group) and zero groups."""
    rng = np.random.default_rng(0)
    g = (rng.standard_normal((4096, 16)) * np.exp2(rng.integers(-14, 10, (4096, 1)))
         ).astype(np.float32)
    g[:8] = 0.0
    g[8:16] = np.float32(0.1)          # constant groups: var may round < 0
    s1, s2 = g.sum(-1), (g * g).sum(-1)
    amax = np.abs(g).max(-1)
    j = [jnp.asarray(v) for v in (s1, s2, amax)]
    t = [torch.from_numpy(v) for v in (s1, s2, amax)]
    np.testing.assert_array_equal(_bits(C.nv_scale_quest(t[0], t[1]).numpy()),
                                  _bits(JC.nv_scale_quest(j[0], j[1])))
    for gs in (1.0, 6.0, 2688.0 / 37.5):
        wb, wm = JC.nv_absmax_scale_bytes(j[2], jnp.float32(gs))
        gb, gm = C.nv_absmax_scale_bytes(t[2], torch.tensor(gs))
        np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
        np.testing.assert_array_equal(_bits(gm.numpy()), _bits(wm))
    wb, wm = JC.nv_quest_scale_bytes(j[0], j[1])
    gb, gm = C.nv_quest_scale_bytes(t[0], t[1])
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    np.testing.assert_array_equal(_bits(gm.numpy()), _bits(wm))


# ---------------------------------------------------------------------------
# fusedQuantizeNv (plain version of K5)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rot", ROTS)
@pytest.mark.parametrize("method", ["abs_max", "quest"])
def test_fused_quantize_nv_matches_jax_and_golden(method, rot):
    """Both layouts.  Scale bytes and codes equal JAX's at a mismatch rate
    <= 1e-4 (measured: 0 for QuEST and at rot 32/128; abs-max at rot 16
    5 of 65536 bytes, at rot 64 3, where the two frameworks' rotation
    sums differ by an ulp); against the fp64 golden, scale bytes within
    2e-2 and dequant values within 1e-1 (tests/test_nvfp4.py)."""
    rng = np.random.default_rng(0)
    x = randn_bf16(rng, 2, 512, 1024)
    h = hadamard_np(rot)
    gsv = 6.0
    for layout in ("rowmajor", "kmajor"):
        want = q.fusedQuantizeNv(jnp.asarray(x), jnp.asarray(h),
                                 jnp.asarray([gsv], jnp.float32), method=method,
                                 layout=layout)
        got = qt.fusedQuantizeNv(to_torch(x), to_torch(h), torch.tensor([gsv]),
                                 method=method, layout=layout)
        for w, g in zip(want, got):
            assert tuple(g.shape) == np.asarray(w).shape and g.dtype == torch.uint8
        assert (got[1].numpy() != np.asarray(want[1])).mean() <= BUDGET
        assert (got[0].numpy() != np.asarray(want[0])).mean() <= BUDGET
    rows, k = 1024, 1024
    ref = G.quantize_nv(x.astype(np.float64).reshape(rows, k), h.astype(np.float64),
                        rot, gsv, method)
    packed, sb = got[0].numpy().T, got[1].numpy().T          # kmajor -> rows
    assert (G.e4m3_to_f64(sb) != G.e4m3_to_f64(ref["e4m3"])).mean() <= 2e-2
    dq = (G.unpack_fp4(packed).reshape(-1, 16)
          * G.e4m3_to_f64(sb).reshape(-1, 1)).reshape(rows, k)
    assert (dq != ref["dq"]).mean() <= 1e-1


def test_global_scale_forms_agree():
    """A number, a 0-dim and a 1-element tensor give the same bytes; a
    tensor of two values raises."""
    rng = np.random.default_rng(3)
    x, h = to_torch(randn_bf16(rng, 8, 256)), to_torch(hadamard_np(32))
    outs = [qt.fusedQuantizeNv(x, h, gs) for gs in
            (3.5, torch.tensor(3.5), torch.tensor([3.5]))]
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(o, outs[0]))
    with pytest.raises(ValueError):
        qt.fusedQuantizeNv(x, h, torch.tensor([1.0, 2.0]))


@pytest.mark.parametrize("bad", ["dtype", "k_div", "method", "layout", "rot"])
def test_nv_validation_errors(bad):
    x = torch.zeros((4, 256), dtype=torch.bfloat16)
    h = qt.hadamard_matrix(32, device="cpu")
    kw = {}
    if bad == "dtype":
        x = x.float()
    elif bad == "k_div":
        x = torch.zeros((4, 24), dtype=torch.bfloat16)
        h = qt.hadamard_matrix(16, device="cpu")[:8, :8]
    elif bad == "method":
        kw = {"method": "absmax"}
    elif bad == "layout":
        kw = {"layout": "kmajor_codes"}
    else:
        h = qt.hadamard_matrix(8, device="cpu")
    with pytest.raises((TypeError, ValueError)):
        qt.fusedQuantizeNv(x, h, 1.0, **kw)
    if bad != "layout":
        with pytest.raises((TypeError, ValueError)):
            qt.fusedQuantizeNvInt8(x, h, 1.0, **kw)


# ---------------------------------------------------------------------------
# fusedQuantizeNvInt8 (plain version of K6) and the int8 encodes
# ---------------------------------------------------------------------------

# the existing (80, 2048) inputs at every rotation, then the rows and K at
# which the Hopper kernel K6 splits its grid, and rows whose groups span
# more than 3 binades
NV_INT8_CASES = ([pytest.param(rot, (80, 2048), "randn", id=str(rot)) for rot in ROTS]
                 + [pytest.param(rot, (rows, k), data, id=f"{rot}-{rows}x{k}-{data}")
                    for rot, (rows, k), data in
                    [(32, (rows, k), "randn") for rows in (1, 4, 13) for k in (96, 160, 4096)]
                    + [(32, (13, 4096), "binades"), (16, (4, 160), "binades")]])


@pytest.mark.parametrize("rot,shape,data", NV_INT8_CASES)
@pytest.mark.parametrize("method", ["abs_max", "quest"])
def test_fused_quantize_nv_int8_matches_jax(method, rot, shape, data):
    """Scale bytes at a mismatch rate <= 1e-4 (measured 0 at every rot
    and method); in every row whose bytes agree, a' and sigma are
    bitwise JAX's."""
    rng = np.random.default_rng(1)
    x, h = randn_bf16(rng, *shape), hadamard_np(rot)
    if data == "binades":
        e = np.exp2(np.random.default_rng(3).integers(-12, 4, (shape[0], shape[1] // 32)))
        x = (x.astype(np.float32) * e.repeat(32, axis=1)).astype(x.dtype)
    wa, ws, wb = q.fusedQuantizeNvInt8(jnp.asarray(x), jnp.asarray(h),
                                       jnp.float32(5.0), method=method)
    ga, gs, gb = qt.fusedQuantizeNvInt8(to_torch(x), to_torch(h), 5.0,
                                        method=method)
    assert (ga.dtype, gs.dtype, gb.dtype) == (torch.int8, torch.float32, torch.uint8)
    assert (gb.numpy() != np.asarray(wb)).mean() <= BUDGET
    same_rows = (gb.numpy() == np.asarray(wb)).all(0)
    assert same_rows.mean() > 0.9
    np.testing.assert_array_equal(ga.numpy()[:, same_rows], np.asarray(wa)[:, same_rows])
    np.testing.assert_array_equal(_bits(gs.numpy()[same_rows]),
                                  _bits(np.asarray(ws)[same_rows]))


@pytest.mark.parametrize("fn", ["encode_nv_int8", "encode_nv_int8_planes",
                                "prepare_weight_nv_int8"])
def test_nv_int8_encodes_bitwise_given_the_same_bytes(fn):
    """From JAX's packed codes and e4m3 bytes (with a NaN byte, a dead
    group, planted), each encode returns JAX's int8 operand and row
    scale bit for bit."""
    rng = np.random.default_rng(2)
    x = randn_bf16(rng, 48, 512) * np.exp2(rng.integers(-6, 6, (48, 1))).astype(
        ml_dtypes.bfloat16)
    wq, ws = q.fusedQuantizeNv(jnp.asarray(x), jnp.asarray(hadamard_np(32)),
                               jnp.float32(2688.0 / 200.0), layout="kmajor")
    ws = np.asarray(ws).copy()
    ws[3, 5] = 0xFF
    want = getattr(JI, fn)(wq, jnp.asarray(ws))
    got = getattr(I8, fn)(torch.from_numpy(np.asarray(wq).copy()), torch.from_numpy(ws))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(_bits(got[1].numpy()), _bits(want[1]))


# ---------------------------------------------------------------------------
# the NVFP4 GEMM (plain version of K7)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rot", ROTS)
@pytest.mark.parametrize("method", ["abs_max", "quest"])
def test_matmul_nvf4_bitwise_to_jax_and_fp64(method, rot):
    """At tests/test_nvfp4.py's shape, given JAX's bytes: tn and kmajor
    outputs equal JAX's bit for bit and equal bf16 of the fp64 dequant
    product."""
    rng = np.random.default_rng(0)
    m, n, k = 504, 512, 2048
    a, b = randn_bf16(rng, m, k), randn_bf16(rng, n, k)
    h, gs = jnp.asarray(hadamard_np(rot)), jnp.asarray([1.0], jnp.float32)
    aq, asf = q.fusedQuantizeNv(jnp.asarray(a), h, gs, method=method)
    bq, bsf = q.fusedQuantizeNv(jnp.asarray(b), h, gs, method=method)
    asf, bsf = np.asarray(asf)[:m, :k // 16], np.asarray(bsf)[:n, :k // 16]
    want = q.matmul_nvf4_bf16_tn(aq, bq, jnp.asarray(asf), jnp.asarray(bsf),
                                 jnp.asarray([1.0], jnp.float32))
    ta, tb = to_torch(aq), to_torch(bq)
    got = qt.matmul_nvf4_bf16_tn(ta, tb, to_torch(asf), to_torch(bsf), torch.tensor([1.0]))
    np.testing.assert_array_equal(to_np(got).view(np.uint16),
                                  np.asarray(want).view(np.uint16))
    dq = lambda p, s: (G.unpack_fp4(np.asarray(p)).reshape(-1, 16)
                       * G.e4m3_to_f64(s).reshape(-1, 1)).reshape(p.shape[0], k)
    ref = (dq(aq, asf) @ dq(bq, bsf).T).astype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(to_np(got).view(np.uint16), ref.view(np.uint16))
    km = qt.matmul_nvf4_bf16_kmajor(ta.T.contiguous(), tb.T.contiguous(),
                                    to_torch(asf.T.copy()), to_torch(bsf.T.copy()), 1.0)
    assert torch.equal(km, got)


# the decode shapes of Qwen3-8B's linears: (K, N) of q/o, k/v, gate/up, down
QWEN3_8B_DECODE_KN = ((4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096))
DECODE_ROWS = [1, 4, 13, 16]


def _nv_kmajor_operands(m, n, k, seed, rot=32):
    """JAX-quantized K-major NVFP4 operands (abs-max, exact global scales)
    of rotated random rows: (JAX arrays, the same as CPU tensors)."""
    rng = np.random.default_rng(seed)
    h = jnp.asarray(hadamard_np(rot))
    x, w = randn_bf16(rng, m, k), randn_bf16(rng, n, k, scale=k ** -0.5)
    gx = jnp.asarray([448.0 * 6 / float(np.abs(x.astype(np.float32)).max())], jnp.float32)
    gw = jnp.asarray([448.0 * 6 / float(np.abs(w.astype(np.float32)).max())], jnp.float32)
    ops = (*q.fusedQuantizeNv(jnp.asarray(x), h, gx, method="abs_max", layout="kmajor"),
           *q.fusedQuantizeNv(jnp.asarray(w), h, gw, method="abs_max", layout="kmajor"))
    aqt, ast, bqt, bst = ops
    return (aqt, bqt, ast, bst), tuple(to_torch(t) for t in (aqt, bqt, ast, bst))


@pytest.mark.parametrize("m", DECODE_ROWS)
@pytest.mark.parametrize("k,n", QWEN3_8B_DECODE_KN)
def test_nv_decode_split_invariants(k, n, m):
    """K7's decode grid at every Qwen3-8B decode shape and 1-132 SMs: K
    slices a multiple of 128 (a 16-group for each of a block's 8 warps),
    at most 2048 long, covering K once (the last slice holds at least one
    group); the fp64 partial sums, slices x M x N x 8 bytes, at most a
    quarter of the weight's N x K x 0.5625 bytes; the column tile holds
    the fp64 sums of at most 16 outputs a thread."""
    cols = KG.fp4_decode_cols(m)
    assert cols * (4 if m <= 4 else 8 if m <= 8 else 16) == 32 * 16 and cols % 32 == 0
    for sms in range(1, 133):
        kc, splits = KG.fp4_decode_split(m, n, k, sms, 16)
        assert kc % 128 == 0 and 128 <= kc <= 2048
        assert (splits - 1) * kc < k <= splits * kc
        assert splits * m * n * 8 <= n * k * 0.5625 / 4


@pytest.mark.parametrize("m", DECODE_ROWS)
@pytest.mark.parametrize("k", [16, 48, 96, 2064, 20480])
def test_nv_decode_split_ragged_k(k, m):
    """Small and ragged K (K % 16 == 0): one slice covers K below 128, and
    every slice count covers K once."""
    for sms in (1, 8, 132):
        kc, splits = KG.fp4_decode_split(m, 33, k, sms, 16)
        assert kc % 128 == 0 and kc <= 2048 and (splits - 1) * kc < k <= splits * kc
        assert splits == 1 or k > 128


@pytest.mark.parametrize("m", DECODE_ROWS)
def test_matmul_nvf4_kmajor_decode_rows_bitwise_to_jax_and_fp64(m):
    """At decode row counts, on rotated data: the port's K-major NVFP4 GEMM
    (the plain version of K7, which the decode kernel is held to on the
    card) equals JAX's ``matmul_nvf4_bf16_kmajor`` bit for bit, and bf16
    of the fp64 dequant product times alpha, in bf16 and fp32 out."""
    n, k = 200, 512
    jops, tops = _nv_kmajor_operands(m, n, k, seed=40 + m)
    want = q.matmul_nvf4_bf16_kmajor(*jops, jnp.asarray([0.37], jnp.float32))
    got = qt.matmul_nvf4_bf16_kmajor(*tops, torch.tensor([0.37]))
    np.testing.assert_array_equal(to_np(got).view(np.uint16), np.asarray(want).view(np.uint16))
    aqt, bqt, ast, bst = (np.asarray(t) for t in jops)
    dq = lambda p, s: (G.unpack_fp4(p.T.copy()).reshape(-1, 16)
                       * G.e4m3_to_f64(s.T.copy()).reshape(-1, 1)).reshape(p.shape[1], k)
    ref = (dq(aqt, ast) @ dq(bqt, bst).T).astype(np.float32) * np.float32(0.37)
    np.testing.assert_array_equal(to_np(got).view(np.uint16),
                                  ref.astype(ml_dtypes.bfloat16).view(np.uint16))
    got32 = qt.matmul_nvf4_bf16_kmajor(*tops, torch.tensor([0.37]), out_dtype=torch.float32)
    np.testing.assert_array_equal(got32.numpy().view(np.int32), ref.view(np.int32))


def _decode_kernel_order(aqt, bqt, ast, bst, alpha, sms, out_dtype=torch.bfloat16):
    """K7's decode kernel's order of sums, in fp64 on the CPU: each group
    term fp32(fp32(p * sa) * sb), p the exact group sum; warp w of a slice
    adds the slice's groups w, w + 8, ... in turn; the block adds its 8
    warps in order, and the last block the slices in order; one rounding
    to fp32, times alpha in fp32."""
    k, m, n = aqt.shape[0] * 2, aqt.shape[1], bqt.shape[1]
    kc, splits = KG.fp4_decode_split(m, n, k, sms, 16)
    av = C.e2m1_decode_f32(E.unpack_codes(aqt.T)).double().reshape(m, k // 16, 16)
    bv = C.e2m1_decode_f32(E.unpack_codes(bqt.T)).double().reshape(n, k // 16, 16)
    p = torch.einsum("mgi,ngi->mng", av, bv).float()          # exact group sums
    sa, sb = C.e4m3_decode_f32(ast.T), C.e4m3_decode_f32(bst.T)  # [m, G], [n, G]
    terms = ((p * sa[:, None, :]) * sb[None, :, :]).double()     # exact, fp32 products
    total = torch.zeros((m, n), dtype=torch.float64)
    for s in range(splits):
        g0, g1 = s * kc // 16, min(k, (s + 1) * kc) // 16
        block = torch.zeros((m, n), dtype=torch.float64)
        for w in range(8):
            acc = torch.zeros((m, n), dtype=torch.float64)
            for g in range(g0 + w, g1, 8):
                acc = acc + terms[:, :, g]
            block = block + acc
        total = total + block
    return (total.float() * torch.tensor(alpha, dtype=torch.float32)).to(out_dtype)


@pytest.mark.parametrize("sms", [1, 16, 132])
@pytest.mark.parametrize("m", DECODE_ROWS)
def test_decode_kernel_order_equals_the_plain_version(m, sms):
    """A model of the decode kernel's order (fp64 group terms folded per
    warp, per K slice, then the slices in order) equals the plain version
    bit for bit on rotated data with several slices: the group terms are
    exact multiples of 2^-20 and their fp64 sums exact, so no order moves
    a bit."""
    n, k = 96, 4096
    _, (aqt, bqt, ast, bst) = _nv_kmajor_operands(m, n, k, seed=60 + m)
    assert KG.fp4_decode_split(m, n, k, sms, 16)[1] > 1
    for od in (torch.bfloat16, torch.float32):
        want = E.matmul_nvf4_bf16_kmajor(aqt, bqt, ast, bst, torch.tensor([0.37]), od)
        got = _decode_kernel_order(aqt, bqt, ast, bst, 0.37, sms, od)
        assert torch.equal(got, want)


# the group fold: the arithmetic of K7's prefill kernel (int m2 group sums,
# the exact term, one fp64 chain an output in ascending k)

@pytest.mark.parametrize("k,n", [(4112, 200), (1040, 33)])
@pytest.mark.parametrize("m", [17, 64, 305])
def test_groupfold_bitwise_to_jax_and_fp64(m, k, n):
    """On rotated data at ragged M, N and K (K % 32 == 16), the group fold
    equals JAX's ``matmul_nvf4_bf16_kmajor`` and ``_tn`` bit for bit in
    bf16, and the port's plain versions and the fp64 dequant product times
    alpha in bf16 and fp32."""
    jops, tops = _nv_kmajor_operands(m, n, k, seed=80 + m, rot=16)
    alpha = 0.37
    aqt, bqt, ast, bst = (np.asarray(t) for t in jops)
    tn = tuple(t.T.contiguous() for t in tops)
    dq = lambda p, s: (G.unpack_fp4(p.T.copy()).reshape(-1, 16)
                       * G.e4m3_to_f64(s.T.copy()).reshape(-1, 1)).reshape(p.shape[1], k)
    ref = (dq(aqt, ast) @ dq(bqt, bst).T).astype(np.float32) * np.float32(alpha)
    want = {"kmajor": q.matmul_nvf4_bf16_kmajor(*jops, jnp.asarray([alpha], jnp.float32)),
            "tn": q.matmul_nvf4_bf16_tn(*(jnp.asarray(np.asarray(t).T) for t in jops),
                                        jnp.asarray([alpha], jnp.float32))}
    for layout, ops in (("kmajor", tops), ("tn", tn)):
        got = E.gemm_fp4_nv_groupfold_plain(*ops, torch.tensor([alpha]), layout=layout)
        np.testing.assert_array_equal(to_np(got).view(np.uint16),
                                      np.asarray(want[layout]).view(np.uint16))
        np.testing.assert_array_equal(to_np(got).view(np.uint16),
                                      ref.astype(ml_dtypes.bfloat16).view(np.uint16))
        got32 = E.gemm_fp4_nv_groupfold_plain(*ops, alpha, layout=layout, out_dtype=torch.float32)
        np.testing.assert_array_equal(got32.numpy().view(np.int32), ref.view(np.int32))
        plain = getattr(E, f"matmul_nvf4_bf16_{layout}")
        for od, g in ((torch.bfloat16, got), (torch.float32, got32)):
            assert torch.equal(g, plain(*ops, torch.tensor([alpha]), od))


def _tile_order(at, bt, ast, bst, alpha, out_dtype):
    """The fp4 tile's arithmetic (``csrc/gemm_fp4_tile.cuh``, which K17
    runs): per 16-group the fp32 sum p of the e2m1 products (exact), the
    fp32 term fp32(fp32(p * sa) * sb) (exact), added into fp64 in
    ascending k; one rounding to fp32, times alpha in fp32."""
    av = C.e2m1_decode_f32(E.unpack_codes(at.T))
    bv = C.e2m1_decode_f32(E.unpack_codes(bt.T))
    sa, sb = C.e4m3_decode_f32(ast.T), C.e4m3_decode_f32(bst.T)
    acc = torch.zeros((av.shape[0], bv.shape[0]), dtype=torch.float64)
    for g in range(av.shape[1] // 16):
        ks = slice(16 * g, 16 * g + 16)
        p = (av[:, ks].double() @ bv[:, ks].double().T).float()
        acc = acc + ((p * sa[:, g, None]) * sb[None, :, g]).double()
    return (acc.float() * torch.tensor(alpha, dtype=torch.float32)).to(out_dtype)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,n,special", [(17, 40, False), (64, 24, True), (33, 72, True)])
def test_groupfold_equals_the_tile_order_on_adversarial_bytes(m, n, special, out_dtype):
    """Where the fp64 sums round, no order is bitwise against the fp64
    product (which differs here): the group fold (int sums, the term from
    MAGIC + s) equals the fp4 tile's order (fp32 sums and terms) bit for
    bit, NaN positions included, in both layouts."""
    ops = nv_adversarial(m, n, 4096, seed=90 + m, special=special)
    want = _tile_order(*ops, 0.37, out_dtype)
    for layout, o in (("kmajor", ops), ("tn", tuple(t.T.contiguous() for t in ops))):
        got = E.gemm_fp4_nv_groupfold_plain(*o, 0.37, layout=layout, out_dtype=out_dtype)
        assert nan_equal(got, want)
    fp64 = E.matmul_nvf4_bf16_kmajor(*ops, 0.37, out_dtype)
    nan = torch.isnan(want.float())
    assert bool(nan.any()) == special
    assert not torch.equal(fp64[~nan], want[~nan])


# ---------------------------------------------------------------------------
# the NV linear
# ---------------------------------------------------------------------------

def _linear_case(seed=21):
    rng = np.random.default_rng(seed)
    return randn_bf16(rng, 16, 256), randn_bf16(rng, 128, 256, scale=0.05), hadamard_np(32)


@pytest.mark.parametrize("weight_format", ["int8", "fp4"])
@pytest.mark.parametrize("static_gsx", [False, True])
def test_nv_linear_matches_jax(weight_format, static_gsx):
    """NV linear, both storages, exact per-call or static gsx: cosine >
    0.999 to JAX's ``_linear`` on JAX's own stored weight, and output
    norm within 0.8-1.25 of x @ w.T (tests/test_models.py)."""
    from qutlass_tpu.models.transformer import _linear as j_linear
    from qutlass_tpu.models.transformer import quantize_weight as j_quantize_weight
    x, w, h = _linear_case()
    jw = j_quantize_weight(jnp.asarray(w), h=jnp.asarray(h), fmt="nv",
                           weight_format=weight_format)
    if static_gsx:
        jw = dict(jw, gsx=jnp.float32(2688.0 / 90.0))
    want = np.asarray(j_linear(jnp.asarray(x), jw, jnp.asarray(h), "quest", True),
                      np.float32)
    tw = convert.params_from_numpy(jax.tree.map(np.asarray, jw), device="cpu")
    got = to_np(nv_linear(to_torch(x), tw, to_torch(h))).astype(np.float32)
    assert cosine(got, want) > 0.999
    ratio = np.linalg.norm(got) / np.linalg.norm(x.astype(np.float32) @ w.astype(np.float32).T)
    assert 0.8 < ratio < 1.25, ratio


@pytest.mark.parametrize("weight_format", ["int8", "fp4"])
def test_nv_quantize_weight_matches_jax(weight_format):
    """The port's NV weight prep against JAX's: the same leaves, the
    global scale within an ulp (the rotated amax of two fp32 products),
    and the stored bytes equal at a mismatch rate <= 1e-4."""
    from qutlass_tpu.models.transformer import quantize_weight as j_quantize_weight
    _, w, h = _linear_case()
    jw = j_quantize_weight(jnp.asarray(w), h=jnp.asarray(h), fmt="nv",
                           weight_format=weight_format)
    tw = quantize_weight(to_torch(w), h=to_torch(h), fmt="nv",
                         weight_format=weight_format)
    assert sorted(tw) == sorted(jw)
    np.testing.assert_allclose(float(tw["gs"]), float(jw["gs"]), rtol=2 ** -23)
    for name in tw:
        if name != "gs":
            assert (tw[name].numpy() != np.asarray(jw[name])).mean() <= BUDGET, name


def test_nv_quantized_linear_module():
    """QuantizedLinear(fmt="nv") holds the NV leaves as buffers and
    equals nv_linear bit for bit; both storages agree at cosine > 0.99."""
    x, w, h = (to_torch(a) for a in _linear_case(5))
    lin = QuantizedLinear.create(w, h, fmt="nv")
    assert set(dict(lin.named_buffers())) == {"nvi8", "nvsb", "gs", "h"}
    y = lin(x.reshape(2, 8, 256))
    assert tuple(y.shape) == (2, 8, 128)
    assert torch.equal(y.reshape(16, 128), nv_linear(x, lin.stored(), h))
    fp4 = QuantizedLinear.create(w, h, fmt="nv", weight_format="fp4")
    assert set(dict(fp4.named_buffers())) == {"wqt", "wst", "gs", "h"}
    assert cosine(to_np(fp4(x)).astype(np.float32), to_np(y.reshape(16, 128)).astype(np.float32)) > 0.99


def test_cpu_nv_tensors_take_the_plain_version():
    """Every NV op on CPU tensors runs the plain version: no launch."""
    dispatch.reset_launch_counts()
    x, w, h = (to_torch(a) for a in _linear_case(6))
    for wf in ("int8", "fp4"):
        nv_linear(x, quantize_weight(w, h=h, fmt="nv", weight_format=wf), h)
    assert all(v == 0 for v in dispatch.launch_counts.values())


# ---------------------------------------------------------------------------
# the entry points default to the card
# ---------------------------------------------------------------------------

def test_default_device_is_the_card():
    assert utils.default_device() == torch.device("cuda")
    assert utils.resolve_device(None) == torch.device("cuda")
    assert utils.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("entry", ["hadamard_matrix", "identity_matrix",
                                   "tensor_from_numpy", "params_from_numpy",
                                   "init_cache"])
def test_entry_point_builds_on_the_default_device(entry, monkeypatch):
    """Called without a device, each entry point builds on
    ``utils.default_device()`` (patched here to "meta", so no card is
    needed to see it)."""
    monkeypatch.setattr(utils, "default_device", lambda: torch.device("meta"))
    if entry == "hadamard_matrix":
        t = qt.hadamard_matrix(16)
    elif entry == "identity_matrix":
        t = qt.identity_matrix(16)
    elif entry == "tensor_from_numpy":
        t = M.tensor_from_numpy(np.ones(3, ml_dtypes.bfloat16))
    elif entry == "params_from_numpy":
        t = M.params_from_numpy({"a": [np.zeros(2, np.int8)]})["a"][0]
    else:
        t = serving.init_cache(M.tiny_config(), 1, 4)[0]["k"]
    assert t.device.type == "meta"


def test_init_params_defaults_to_the_card():
    """init_params draws on the card unless told otherwise: a CPU
    generator without ``device`` is refused before anything is drawn."""
    with pytest.raises(ValueError, match="cuda"):
        M.init_params(M.tiny_config(), torch.Generator())
    p = M.init_params(M.tiny_config(num_layers=1), torch.Generator(), device="cpu")
    assert p["embed"].device.type == "cpu"
