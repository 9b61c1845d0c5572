"""K4's arithmetic on the CPU: the exact 32-group fold that K4's kernels
and K16 run (``ops.emulation.gemm_fp4_mx_groupfold_plain``), the order
of K4's split-K decode kernel, and the decode kernel's term and grid.

Tolerances: bitwise throughout (NaN positions aside where a NaN scale
byte is given).
  * The group fold against JAX's ``matmul_mxf4_bf16_kmajor``, ``_tn`` and
    ``_kmajor_codes`` (bf16) and the port's plain versions (bf16 and
    fp32) on rotated data at ragged M, N and K (K % 64 == 32).
  * A model of the decode kernel's order (fp64 group terms folded per
    warp, per K slice, then the slices in order) against the plain
    version at decode rows with several slices.
  * Scale bytes spread over ~29 binades: the fold equals the fp64
    product, and a model of the one fp32 ``fmaf`` chain over K that K4
    ran before does not (why the arithmetic changed).
  * Scale bytes 240-254 against 0-14: the fold equals the fp64 product of
    operands decoded in fp64, where the plain versions' bf16 dequant
    saturates to inf.
  * Where fp64 sums round (``mx_adversarial``) the fold is the tile's
    order and differs from the fp64 product, NaN positions alike.
  * The decode kernel's term fma(fma(MAGIC + s, sa/4, -MAGIC sa/4), sb, 0)
    against exact rationals at scale bytes 0, 1, 127, 253 and 254.
  * The decode grid (``fp4_decode_split`` with 32-groups) at every
    Qwen3-8B decode shape and 1-132 SMs.
  * A numpy model of the prefill kernel's arithmetic (``csrc/
    gemm_fp4_prefill.cuh`` with ``dec::Mx``: int8 m2 products summed per
    32-group to s = 4p, the table pair {v/4, -MAGIC v/4} of the 256 e8m0
    bytes, one fold a group in ascending k) against JAX and the group
    fold at M in {17, 64, 305}, K in {96, 1056, 4128} (K % 64 == 32) and
    ragged N in the three layouts; against the group fold where fp64 sums
    round and at scale bytes 0, 253, 254 and 255.
  * Every e8m0 table entry exact, and the two-FMA term with an
    accumulator acc + p sa sb rounded once, against exact rationals.
"""
import struct
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qutlass_tpu as q
from qutlass_tpu_torch.formats import codecs as C
from qutlass_tpu_torch.kernels import gemm as KG
from qutlass_tpu_torch.ops import emulation as E
from torch_helpers import hadamard_np, mx_adversarial, mx_spread, randn_bf16, to_np, to_torch

QWEN3_8B_DECODE_KN = ((4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096))
DECODE_ROWS = [1, 4, 13, 16]
ALPHA = 0.37


def _bits(y) -> np.ndarray:
    return (to_np(y) if isinstance(y, torch.Tensor) else np.asarray(y)).view(np.uint16)


def _jax_operands(m, n, k, seed):
    """JAX-quantized MXFP4 operands (QuEST, rotation 32) of random rows:
    {layout: (a, b, a_sf, b_sf)} as JAX arrays and as CPU tensors, for
    ``kmajor``, ``kmajor_codes`` (unpacked activation codes) and ``tn``."""
    rng = np.random.default_rng(seed)
    h = jnp.asarray(hadamard_np(32))
    xa, xb = jnp.asarray(randn_bf16(rng, m, k)), jnp.asarray(randn_bf16(rng, n, k))
    at, ast = q.fusedQuantizeMx(xa, h, method="quest", layout="kmajor")
    ac, _ = q.fusedQuantizeMx(xa, h, method="quest", layout="kmajor_codes")
    bt, bst = q.fusedQuantizeMx(xb, h, method="quest", layout="kmajor")
    jops = {"kmajor": (at, bt, ast, bst), "kmajor_codes": (ac, bt, ast, bst),
            "tn": tuple(jnp.asarray(np.asarray(t).T) for t in (at, bt, ast, bst))}
    return jops, {lay: tuple(to_torch(t) for t in ops) for lay, ops in jops.items()}


@pytest.mark.parametrize("k,n", [(4128, 200), (1056, 33)])
@pytest.mark.parametrize("m", [1, 4, 17, 64, 305])
def test_mx_groupfold_bitwise_to_jax_and_plain(m, k, n):
    """On rotated data at ragged M, N and K (K % 64 == 32), the group fold
    equals JAX's ``matmul_mxf4_bf16_kmajor``, ``_kmajor_codes`` and ``_tn``
    bit for bit in bf16, and the port's plain versions in bf16 and fp32."""
    jops, tops = _jax_operands(m, n, k, seed=90 + m)
    jal = jnp.asarray([ALPHA], jnp.float32)
    for layout, ops in tops.items():
        want = getattr(q, f"matmul_mxf4_bf16_{layout}")(*jops[layout], jal)
        got = E.gemm_fp4_mx_groupfold_plain(*ops, torch.tensor([ALPHA]), layout=layout)
        np.testing.assert_array_equal(_bits(got), _bits(want))
        got32 = E.gemm_fp4_mx_groupfold_plain(*ops, ALPHA, layout=layout,
                                              out_dtype=torch.float32)
        for od, g in ((torch.bfloat16, got), (torch.float32, got32)):
            plain = KG.gemm_fp4_mx_plain(*ops, torch.tensor([ALPHA]), layout=layout,
                                         out_dtype=od)
            assert torch.equal(g, plain), (layout, od)


def _decode_kernel_order(aqt, bqt, ast, bst, alpha, sms, out_dtype=torch.bfloat16):
    """K4's decode kernel's order of sums, in fp64 on the CPU: each group
    term (s * sa/4) * sb, s = 4p the exact integer group sum; warp w of a
    slice adds the slice's groups w, w + 8, ... in turn; the block adds
    its 8 warps in order, and the last block the slices in order; one
    rounding to fp32, times alpha in fp32."""
    k, m, n = aqt.shape[0] * 2, aqt.shape[1], bqt.shape[1]
    kc, splits = KG.fp4_decode_split(m, n, k, sms, 32)
    m2a = (C.e2m1_decode_f32(E.unpack_codes(aqt.T)).double() * 2).reshape(m, k // 32, 32)
    m2b = (C.e2m1_decode_f32(E.unpack_codes(bqt.T)).double() * 2).reshape(n, k // 32, 32)
    s = torch.einsum("mgi,ngi->mng", m2a, m2b)                       # exact integers
    sa = C.e8m0_decode_f32(ast.T).double() / 4                        # [m, G]
    sb = C.e8m0_decode_f32(bst.T).double()                            # [n, G]
    terms = (s * sa[:, None, :]) * sb[None, :, :]                     # exact
    total = torch.zeros((m, n), dtype=torch.float64)
    for sp in range(splits):
        g0, g1 = sp * kc // 32, min(k, (sp + 1) * kc) // 32
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
def test_mx_decode_kernel_order_equals_the_plain_version(m, sms):
    """A model of the decode kernel's order equals the plain version and
    the group fold bit for bit on rotated data with several slices: the
    fp64 sums of the exact group terms are exact there, so no order moves
    a bit."""
    n, k = 96, 4096
    _, tops = _jax_operands(m, n, k, seed=60 + m)
    ops = tops["kmajor"]
    assert KG.fp4_decode_split(m, n, k, sms, 32)[1] > 1
    for od in (torch.bfloat16, torch.float32):
        want = E.matmul_mxf4_bf16_kmajor(*ops, torch.tensor([ALPHA]), od)
        got = _decode_kernel_order(*ops, ALPHA, sms, od)
        assert torch.equal(got, want)
        assert torch.equal(got, E.gemm_fp4_mx_groupfold_plain(*ops, ALPHA, layout="kmajor",
                                                              out_dtype=od))


def _fp32_chain(aqt, bqt, ast, bst, alpha, out_dtype):
    """The arithmetic K4 ran before the group fold: the operands dequantized
    (exact in bf16), one fp32 fmaf chain over k ascending (each product
    exact in fp32, so a chain step is one fp32 addition), times alpha."""
    da = E.dequant_fp4(E.unpack_codes(aqt.T), ast.T).float()
    db = E.dequant_fp4(E.unpack_codes(bqt.T), bst.T).float()
    acc = torch.zeros((da.shape[0], db.shape[0]), dtype=torch.float32)
    for kk in range(da.shape[1]):
        acc = acc + da[:, kk, None] * db[None, :, kk]
    return (acc * torch.tensor(alpha, dtype=torch.float32)).to(out_dtype)


@pytest.mark.parametrize("m,n,seed", [(4, 33, 1), (16, 64, 2), (17, 40, 3)])
def test_mx_groupfold_exact_where_an_fp32_chain_rounds(m, n, seed):
    """Group scales spread over ~29 binades: the fp32 partial sums of one
    chain over K need more than 24 bits and round, while the fp64 fold of
    exact group terms does not.  The fold and the decode kernel's order
    equal the fp64 product bit for bit; the fp32 chain differs from it."""
    k = 1024
    ops = mx_spread(m, n, k, seed)
    for od in (torch.bfloat16, torch.float32):
        want = E.matmul_mxf4_bf16_kmajor(*ops, ALPHA, od)
        assert torch.equal(E.gemm_fp4_mx_groupfold_plain(*ops, ALPHA, layout="kmajor",
                                                         out_dtype=od), want)
        assert torch.equal(_decode_kernel_order(*ops, ALPHA, 132, od), want)
    chain = _fp32_chain(*ops, ALPHA, torch.float32)
    assert not torch.equal(chain, E.matmul_mxf4_bf16_kmajor(*ops, ALPHA, torch.float32))


def _dq64(q, s):
    """K-major packed codes [K/2, R] and e8m0 bytes [K/32, R] -> fp64
    values [R, K], decoded in fp64 (exact for every byte but 255)."""
    v = C.e2m1_decode_f32(E.unpack_codes(q.T)).double()
    r, k = v.shape
    return (v.reshape(r, k // 32, 32) * C.e8m0_decode_f32(s.T).double()[..., None]).reshape(r, k)


@pytest.mark.parametrize("layout", ["kmajor", "tn"])
def test_mx_groupfold_exact_where_the_bf16_dequant_saturates(layout):
    """a's scale bytes 240-254 against b's 0-14: the plain versions' bf16
    dequant saturates to inf at bytes 253-254 (6 * 2^126 > bf16's max), so
    their outputs are not finite; the fold keeps the exact terms and
    equals the fp64 product of operands decoded in fp64, rounded once."""
    m, n, k = 5, 40, 1024
    ops = mx_spread(m, n, k, seed=7, a_bytes=(240, 255), b_bytes=(0, 15))
    ref = (_dq64(ops[0], ops[2]) @ _dq64(ops[1], ops[3]).T).float() * torch.tensor(ALPHA)
    assert bool(torch.isfinite(ref).all())
    if layout == "tn":
        ops = tuple(t.T.contiguous() for t in ops)
    for od in (torch.bfloat16, torch.float32):
        got = E.gemm_fp4_mx_groupfold_plain(*ops, ALPHA, layout=layout, out_dtype=od)
        assert torch.equal(got, ref.to(od))
        plain = KG.gemm_fp4_mx_plain(*ops, ALPHA, layout=layout, out_dtype=od)
        assert not bool(torch.isfinite(plain).all())


@pytest.mark.parametrize("special", [False, True])
def test_mx_groupfold_differs_from_fp64_where_fp64_rounds(special):
    """Where the fp64 sums round (terms near the ulp of a running sum near
    2^56) no order is bitwise against the fp64 product: the fold (the
    tile's ascending order, which the kernels are held to on the card)
    differs from it, with NaN in the same places."""
    ops = mx_adversarial(12, 40, 4096, seed=5, special=special)
    fold = E.gemm_fp4_mx_groupfold_plain(*ops, ALPHA, layout="kmajor", out_dtype=torch.float32)
    fp64 = E.matmul_mxf4_bf16_kmajor(*ops, ALPHA, torch.float32)
    nan = torch.isnan(fold)
    assert torch.equal(nan, torch.isnan(fp64)) and bool(nan.any()) == special
    assert not torch.equal(fold[~nan], fp64[~nan])


MAGIC = 6755401588539392.0      # 2^52 + 2^51 + 2^31, as in csrc/gemm_fp4_decode.cuh


def _fma(x: float, y: float, z: float) -> float:
    """fp64 fma: x * y + z rounded once (exact rationals, then to nearest)."""
    return float(Fraction(x) * Fraction(y) + Fraction(z))


@pytest.mark.parametrize("eb", [0, 1, 127, 253, 254])
@pytest.mark.parametrize("ea", [0, 1, 127, 253, 254])
def test_mx_decode_term_is_exact_at_extreme_scale_bytes(ea, eb):
    """The decode kernel's double MAGIC + s from bits (high word 0x43380000,
    low word s ^ 2^31) is MAGIC + s, and fma(fma(MAGIC + s, sa/4, -MAGIC
    sa/4), sb, 0) is the exact term s/4 * sa * sb for every group sum s
    (|s| <= 32 * 144) at scale bytes from 2^-127 (byte 0) to 2^127 (254)."""
    sa, sb = (float(C.e8m0_decode_f32(torch.tensor(e)).double()) for e in (ea, eb))
    assert Fraction(sa) == Fraction(2) ** (ea - 127) and Fraction(sb) == Fraction(2) ** (eb - 127)
    for s in (-4608, -4607, -12, -1, 0, 1, 3, 1151, 4095, 4608):
        d = struct.unpack("<d", struct.pack("<II", (s ^ 0x80000000) & 0xFFFFFFFF, 0x43380000))[0]
        assert d == MAGIC + s
        inner = _fma(d, sa / 4, -MAGIC * sa / 4)
        assert Fraction(inner) == Fraction(s) * Fraction(sa) / 4
        assert Fraction(_fma(inner, sb, 0.0)) == Fraction(s) * Fraction(sa) * Fraction(sb) / 4


@pytest.mark.parametrize("m", DECODE_ROWS)
@pytest.mark.parametrize("k,n", QWEN3_8B_DECODE_KN)
def test_mx_decode_split_invariants(k, n, m):
    """K4's decode grid at every Qwen3-8B decode shape and 1-132 SMs: K
    slices a multiple of 256 (a 32-group for each of a block's 8 warps),
    at most 2048 long, covering K once; the fp64 partial sums, slices x M
    x N x 8 bytes, at most a quarter of the weight's N x K x 0.53125
    bytes."""
    for sms in range(1, 133):
        kc, splits = KG.fp4_decode_split(m, n, k, sms, 32)
        assert kc % 256 == 0 and 256 <= kc <= 2048
        assert (splits - 1) * kc < k <= splits * kc
        assert splits * m * n * 8 <= n * k * 0.53125 / 4


@pytest.mark.parametrize("k", [32, 96, 2080, 20480])
def test_mx_decode_split_ragged_k(k):
    """Small and ragged K (K % 32 == 0): one slice covers K below 256, and
    every slice count covers K once."""
    for m in DECODE_ROWS:
        for sms in (1, 8, 132):
            kc, splits = KG.fp4_decode_split(m, 33, k, sms, 32)
            assert kc % 256 == 0 and kc <= 2048 and (splits - 1) * kc < k <= splits * kc
            assert splits == 1 or k > 256


# the doubled e2m1 magnitudes of codes 0..7 (the m2 the kernels stage as int8)
E2M1_M2 = np.array([0, 1, 2, 3, 4, 6, 8, 12], np.int64)


def _np_codes(a: np.ndarray, layout: str) -> np.ndarray:
    """A K4 operand in ``layout`` -> its int codes [rows, K]."""
    if layout == "kmajor_codes":
        return a.T.astype(np.int64)
    rows = (a if layout == "tn" else a.T).astype(np.int64)          # packed [rows, K/2]
    return np.stack([rows & 0xF, rows >> 4], -1).reshape(rows.shape[0], -1)


def _scale_tables():
    """The prefill kernel's tables of the 256 e8m0 bytes: tab_a = {v/4,
    -MAGIC v/4} and tab_b = v (v = 2^(byte - 127), NaN at 255)."""
    v = C.e8m0_decode_f32(torch.arange(256)).double().numpy()
    return 0.25 * v, -MAGIC * (0.25 * v), v


def _prefill_model(a, b, a_sf, b_sf, alpha, layout, out_dtype):
    """K4's prefill kernel's arithmetic in numpy: per 32-group the integer
    s = 4p of the int8 m2 products (one m16n8k32 MMA), the fold acc = fma(
    fma(MAGIC + s, sa/4, -MAGIC sa/4), sb, acc) in ascending k, then one
    rounding to fp32, times alpha in fp32.  numpy has no fma: (MAGIC + s)
    times a power of two and the cancelling add are exact, and so is the
    product by sb, so each step rounds once where the fma does
    (``test_mx_prefill_fold_term_with_an_accumulator``)."""
    ca = _np_codes(np.asarray(a), layout)
    cb = _np_codes(np.asarray(b), "tn" if layout == "tn" else "kmajor")
    sa = np.asarray(a_sf) if layout == "tn" else np.asarray(a_sf).T   # bytes [M, K/32]
    sb = np.asarray(b_sf) if layout == "tn" else np.asarray(b_sf).T
    m2a = np.where(ca & 8, -E2M1_M2[ca & 7], E2M1_M2[ca & 7])
    m2b = np.where(cb & 8, -E2M1_M2[cb & 7], E2M1_M2[cb & 7])
    tax, tay, tb = _scale_tables()
    acc = np.zeros((ca.shape[0], cb.shape[0]), np.float64)
    for g in range(ca.shape[1] // 32):
        s = m2a[:, 32 * g:32 * g + 32] @ m2b[:, 32 * g:32 * g + 32].T   # |s| <= 4608
        inner = (MAGIC + s) * tax[sa[:, g]][:, None] + tay[sa[:, g]][:, None]   # p sa
        acc = acc + inner * tb[sb[:, g]][None, :]
    y = acc.astype(np.float32) * np.float32(alpha)
    return torch.from_numpy(y).to(out_dtype)


@pytest.mark.parametrize("k,n", [(96, 200), (1056, 33), (4128, 72)])
@pytest.mark.parametrize("m", [17, 64, 305])
def test_mx_prefill_model_bitwise_to_jax_and_fold(m, k, n):
    """The model of the prefill kernel equals JAX's ``matmul_mxf4_bf16_*``
    (bf16) and the group fold (bf16 and fp32) bit for bit on rotated data,
    in the kmajor, kmajor_codes and tn layouts, at ragged M and N and K %
    64 in {32, 0}."""
    jops, tops = _jax_operands(m, n, k, seed=40 + m + k)
    jal = jnp.asarray([ALPHA], jnp.float32)
    for layout, ops in tops.items():
        for od in (torch.bfloat16, torch.float32):
            got = _prefill_model(*ops, ALPHA, layout, od)
            fold = E.gemm_fp4_mx_groupfold_plain(*ops, ALPHA, layout=layout, out_dtype=od)
            assert torch.equal(got, fold), (layout, od)
            if od == torch.bfloat16:
                want = getattr(q, f"matmul_mxf4_bf16_{layout}")(*jops[layout], jal)
                np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("case", ["round", "round_nan", "extreme"])
@pytest.mark.parametrize("layout", ["kmajor", "tn", "kmajor_codes"])
def test_mx_prefill_model_equals_the_fold_at_adversarial_bytes(layout, case):
    """Where fp64 sums round (``mx_adversarial``, with NaN bytes) and at
    scale bytes 0, 253, 254 (``mx_spread`` over 240-254 and 0-14) and 255,
    the model equals the group fold bit for bit, NaN positions included."""
    m, n = 33, 40
    if case == "extreme":
        ops = list(mx_spread(m, n, 1024, seed=3, a_bytes=(240, 255), b_bytes=(0, 15)))
        ops[2][1, 2], ops[3][31, n - 1] = 255, 255
    else:
        ops = list(mx_adversarial(m, n, 4096, seed=4, special=case == "round_nan"))
    ops = tuple(ops)
    if layout == "tn":
        ops = tuple(t.T.contiguous() for t in ops)
    elif layout == "kmajor_codes":
        ops = (E.unpack_codes(ops[0].T).T.contiguous().to(torch.uint8), *ops[1:])
    for od in (torch.bfloat16, torch.float32):
        got = _prefill_model(*ops, ALPHA, layout, od)
        want = E.gemm_fp4_mx_groupfold_plain(*ops, ALPHA, layout=layout, out_dtype=od)
        gn, wn = torch.isnan(got.float()), torch.isnan(want.float())
        assert torch.equal(gn, wn) and bool(gn.any()) == (case != "round")
        assert torch.equal(got[~gn], want[~wn])


def test_mx_prefill_scale_table_is_exact():
    """Both entries of the table pair {v/4, -MAGIC v/4}, and v itself, are
    exact for all 256 e8m0 bytes (2^(byte - 127), 2^-127 at byte 0): MAGIC
    has three bits set and the exponents stay within fp64's normal range;
    byte 255 gives NaN in all three."""
    tax, tay, tb = _scale_tables()
    for byte in range(256):
        if byte == 255:
            assert np.isnan(tax[byte]) and np.isnan(tay[byte]) and np.isnan(tb[byte])
            continue
        v = Fraction(2) ** (byte - 127)
        assert Fraction(tb[byte]) == v and Fraction(tax[byte]) == v / 4
        assert Fraction(tay[byte]) == -Fraction(MAGIC) * v / 4


@pytest.mark.parametrize("eb", [0, 1, 127, 253, 254])
@pytest.mark.parametrize("ea", [0, 1, 127, 253, 254])
def test_mx_prefill_fold_term_with_an_accumulator(ea, eb):
    """fma(fma(MAGIC + s, sa/4, -MAGIC sa/4), sb, acc) is acc + s/4 sa sb
    rounded once (exact rationals), for group sums s up to 32 * 144 and
    accumulators across fp64's range, at scale bytes 0 to 254; the model's
    two numpy operations give the same double."""
    tax, tay, tb = _scale_tables()
    sa, sb = Fraction(2) ** (ea - 127), Fraction(2) ** (eb - 127)
    for s in (-4608, -4607, -12, -1, 0, 1, 3, 1151, 4095, 4608):
        inner = _fma(MAGIC + s, tax[ea], tay[ea])
        assert Fraction(inner) == Fraction(s) * sa / 4
        for acc in (0.0, 1.5, -3.25e10, 2.0 ** -300, -(2.0 ** 200), 7.0 * 2.0 ** 120,
                    float(Fraction(s) * sa * sb / 4) * (1 + 2.0 ** -52)):
            want = float(Fraction(acc) + Fraction(s) * sa * sb / 4)
            assert _fma(inner, tb[eb], acc) == want
            assert acc + ((MAGIC + s) * tax[ea] + tay[ea]) * tb[eb] == want
