"""Each Hopper kernel against its plain PyTorch version on the card, at
small shapes.  Marked ``gpu``: they skip without a CUDA device and run on
the H100 through ``chip_smoke.py`` (which runs this file with
``--noconftest``, since the repo's conftest imports JAX).  This file
imports no JAX.

Tolerances: K1 and K5 (the fp4 quantizers) bitwise against their
ordered plain versions (``emulation.fused_quantize_{mx,nv}_ordered_plain``,
the kernels' orders of sums), and against the public plain versions
(cuBLAS's order): MX scale bytes exact and codes within a 1e-4 mismatch
rate, NV scale bytes and codes within a 1e-4 mismatch rate (an e4m3
byte, unlike a power-of-two floor, moves with an ulp of its input); K2
and K6 likewise against the public plain versions, K6's a' and sigma
equal wherever a row's bytes agree; GEMMs
bitwise, but K11 (fp32 sums of each 32-group, then fp64) within a 1e-3
bf16 mismatch rate and 1 ulp of its fp64 plain version; the QAT
backward kernels K8-K10, K14 and K15 bitwise (a NaN's bf16 bits aside);
K12 and K13 scale bytes exact and codes within a 1e-4 mismatch rate (the
rotation's fp32 sums in another order than cuBLAS's); one
quartet_linear step on the card within cosine 0.9999 of the CPU step
(K1's codes and cuBLAS's sums differ from the CPU's in order); K16 and
K17 bitwise against the composition on the card (K1 + K4, K5 + K7) and
against their plain versions in every row whose quantized activation
the plain quantizer gives bit for bit; K4's split-K decode kernel (M <=
16, K-major) and its prefill kernel bitwise against the plain version where
the fp64 sums of exact group terms are exact, and against
``gemm_fp4_mx_groupfold_plain`` (the prefill kernel's order, which K16
shares) where they round or where the plain version's bf16 dequant
saturates (scale bytes 253-254), NaN positions aside; K7's split-K decode kernel (M <=
16) bitwise against its plain version (its fp64 sums of exact group
terms are exact for the scale bytes it is given, so the split order
moves no bit), NaN positions aside where a NaN scale byte is given;
K7's prefill kernel bitwise against its plain version on such bytes,
and against ``gemm_fp4_nv_groupfold_plain`` (its own order of sums) on
scale bytes whose fp64 sums round, NaN positions aside.
"""
import pytest
import torch

import qutlass_tpu_torch as qt
from qutlass_tpu_torch import models as M
from qutlass_tpu_torch.kernels import backward as B
from qutlass_tpu_torch.kernels import fused_linear as FL
from qutlass_tpu_torch.kernels import gemm as G
from qutlass_tpu_torch.kernels import quantize as Q
from qutlass_tpu_torch.ops import dispatch
from qutlass_tpu_torch.ops import emulation as E
from qutlass_tpu_torch.nn import linear as L
from qutlass_tpu_torch.ops import int8path as I8
from torch_helpers import (MX_ORDER_GROUP, NV_ORDER_GROUP, mx_adversarial, mx_spread, nan_equal,
                           nv_adversarial)

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _x(dev, *shape, seed=0, scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale).to(torch.bfloat16)


def _codes(q, layout):
    """Packed or unpacked quantizer output -> int codes [rows, K]."""
    if layout == "rowmajor":
        return E.unpack_codes(q)
    if layout == "kmajor":
        return E.unpack_codes(q.T)
    return q.T.to(torch.int32)


# K1 and K5: the ragged shapes, then rows 1, 4, 13, 16, 17 and 512 (the
# kernels' row tiles and their edges) at K 96, 160, 4096 and 12288, every
# rotation size that divides K
FP4_Q_CASES = ([(16, (70, 640)), (32, (70, 640)), (64, (70, 640)), (128, (70, 640)),
                (16, (33, 160)), (32, (1, 96))]
               + [(rot, (rows, k)) for rows in (1, 4, 13, 16, 17, 512)
                  for k in (96, 160, 4096, 12288) for rot in (16, 32, 64, 128) if k % rot == 0])


def _bitwise(got, want) -> bool:
    return len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("layout", ["rowmajor", "kmajor", "kmajor_codes"])
@pytest.mark.parametrize("rot,shape", FP4_Q_CASES)
@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_quantize_mx_kernel(dev, method, rot, shape, layout):
    """Codes, scale bytes and mask bitwise the ordered plain version (the
    kernel's orders of sums); against the plain version (cuBLAS's order)
    scale bytes exact, codes and mask within a 1e-4 mismatch rate."""
    x, h = _x(dev, *shape, scale=25.0), qt.hadamard_matrix(rot, device=dev)
    mask = method == "quest"
    got = Q.quantize_mx(x, h, rot_size=rot, method=method, return_mask=mask,
                        layout=layout)
    want = Q.quantize_mx_plain(x, h, rot_size=rot, method=method,
                               return_mask=mask, layout=layout)
    torch.cuda.synchronize()
    assert _bitwise(got, E.fused_quantize_mx_ordered_plain(
        x, h, rot_size=rot, method=method, return_mask=mask, layout=layout))
    assert torch.equal(got[1], want[1])
    assert (_codes(got[0], layout) != _codes(want[0], layout)).float().mean() <= 1e-4
    if mask:
        assert (got[2] != want[2]).float().mean() <= 1e-4


def _fp4_quantizers(dev, rot, h=None):
    h = qt.hadamard_matrix(rot, device=dev) if h is None else h
    gs = torch.tensor([2.5], device=dev)
    return {"mx": (lambda x, **kw: Q.quantize_mx(x, h, rot_size=rot, layout="kmajor", **kw),
                   lambda x, **kw: E.fused_quantize_mx_ordered_plain(
                       x, h, rot_size=rot, layout="kmajor", **kw)),
            "nv": (lambda x, **kw: Q.quantize_nv(x, h, gs, rot_size=rot, layout="kmajor", **kw),
                   lambda x, **kw: E.fused_quantize_nv_ordered_plain(
                       x, h, gs, rot_size=rot, layout="kmajor", **kw))}


@pytest.mark.parametrize("rows,k", [(4, 4096), (13, 160), (512, 1024)])
@pytest.mark.parametrize("fmt", ["mx", "nv"])
def test_fp4_quantizer_in_cuda_graph(dev, fmt, rows, k):
    """K1 (with the clip mask) and K5 captured in a CUDA graph and replayed
    on new inputs give the eager call's bytes: one launch each, no host
    sync and no scratch."""
    fn, _ = _fp4_quantizers(dev, 32)[fmt]
    kw = {"return_mask": True} if fmt == "mx" else {}
    static_x = _x(dev, rows, k, seed=7, scale=25.0)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn(static_x, **kw)              # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    before = dispatch.launch_counts[f"quantize_{fmt}"]
    with torch.cuda.graph(graph, stream=stream):
        out = fn(static_x, **kw)
    assert dispatch.launch_counts[f"quantize_{fmt}"] == before + 1
    for seed in (8, 9, 10):
        static_x.copy_(_x(dev, rows, k, seed=seed, scale=25.0))
        graph.replay()
        torch.cuda.synchronize()
        assert _bitwise(out, fn(static_x, **kw))


@pytest.mark.parametrize("fmt", ["mx", "nv"])
def test_fp4_quantizers_keep_the_butterfly_order(dev, fmt):
    """Under the identity rotation, rows of a group whose QuEST sums round
    to another scale byte from left to right than in the xor butterfly
    (tests/test_torch_quantize_order.py): K1 and K5 give the ordered plain
    version's bytes."""
    vals = MX_ORDER_GROUP if fmt == "mx" else NV_ORDER_GROUP
    n = len(vals)
    row = torch.tensor(vals, device=dev).repeat(4096 // n).to(torch.bfloat16)
    x = torch.stack([row, -row, row.roll(n), row * 2]).contiguous()
    fn, ordered = _fp4_quantizers(dev, n, torch.eye(n, device=dev, dtype=torch.bfloat16))[fmt]
    kw = {"method": "quest"}
    assert _bitwise(fn(x, **kw), ordered(x, **kw))


# K2 and K6 split K over a grid of (row tiles of 16 rows at rows <= 16, 32
# above) x (128-column chunks): rows and K at the grid's edges (K = 160
# gives a ragged last chunk), every rotation size that divides K; the
# rows <= 16 calls run as one launch, the others as memset + two launches
INT8_Q_CASES = ([(16, (13, 1536), "randn"), (32, (13, 1536), "randn"),
                 (128, (13, 1536), "randn"), (32, (9, 160), "randn")]
                + [(rot, (rows, k), "randn") for rows in (1, 4, 13, 33, 512)
                   for k in (96, 160, 4096, 12288) for rot in (16, 32, 64, 128)
                   if k % rot == 0]
                + [(rot, shape, data) for data in ("binades", "zero_row")
                   for rot, shape in ((32, (4, 4096)), (16, (33, 160)), (128, (40, 1024)))])


def _x_int8(dev, rows, k, data, seed=1):
    """Activations [rows, k]: seeded normal values; "binades": every
    32-group scaled by 2^U(-12, 4), so a row's groups span more than 3
    binades (deficit > 3: a' rounds); "zero_row": rows 0 and rows-1 zero."""
    x = _x(dev, rows, k, seed=seed)
    if data == "binades":
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        e = torch.randint(-12, 5, (rows, k // 32), generator=g, device=dev)
        x = (x.float() * torch.exp2(e.float()).repeat_interleave(32, 1)).to(torch.bfloat16)
    elif data == "zero_row":
        x[0] = 0
        x[-1] = 0
    return x


@pytest.mark.parametrize("rot,shape,data", INT8_Q_CASES)
@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_quantize_mx_int8_kernel(dev, method, rot, shape, data):
    x, h = _x_int8(dev, *shape, data), qt.hadamard_matrix(rot, device=dev)
    ga, gs, gb = Q.quantize_mx_int8(x, h, rot_size=rot, method=method)
    wa, ws, wb = Q.quantize_mx_int8_plain(x, h, rot_size=rot, method=method)
    torch.cuda.synchronize()
    assert torch.equal(gb, wb) and torch.equal(gs, ws)
    assert (ga != wa).float().mean() <= 1e-4


def _int8_quantizers(dev, rot):
    h = qt.hadamard_matrix(rot, device=dev)
    gs = torch.tensor([2688.0 / 5.0], device=dev)
    return {"mx": (lambda x: Q.quantize_mx_int8(x, h, rot_size=rot),
                   lambda x: Q.quantize_mx_int8_plain(x, h, rot_size=rot)),
            "nv": (lambda x: Q.quantize_nv_int8(x, h, gs, rot_size=rot),
                   lambda x: Q.quantize_nv_int8_plain(x, h, gs, rot_size=rot))}


def _int8_q_equal(kind, got, want) -> bool:
    """K2: bytes and row scales equal, a' within 1e-4; K6: bytes within
    1e-4, a' and sigma equal where a row's bytes agree."""
    (ga, gs, gb), (wa, ws, wb) = got, want
    if kind == "mx":
        return (torch.equal(gb, wb) and torch.equal(gs, ws)
                and (ga != wa).float().mean().item() <= 1e-4)
    same = (gb == wb).all(0)
    return ((gb != wb).float().mean().item() <= 1e-4 and torch.equal(ga[:, same], wa[:, same])
            and torch.equal(gs[same], ws[same]))


@pytest.mark.parametrize("rows,k", [(4, 4096), (13, 160), (512, 1024)])
@pytest.mark.parametrize("kind", ["mx", "nv"])
def test_int8_quantizer_repeats_bitwise(dev, kind, rows, k):
    """Two launches on one input give the same bits: the row maximum's
    atomics may land in any order, and a one-launch call leaves its
    scratch zero for the next."""
    fn, _ = _int8_quantizers(dev, 32)[kind]
    x = _x_int8(dev, rows, k, "binades", seed=5)
    first = [t.clone() for t in fn(x)]
    for _ in range(3):
        again = fn(x)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("rows,k", [(4, 4096), (4, 12288), (512, 1024)])
@pytest.mark.parametrize("kind", ["mx", "nv"])
def test_int8_quantizer_in_cuda_graph(dev, kind, rows, k):
    """A call captured in a CUDA graph and replayed on new inputs equals
    the plain version: the scratch is reset on the stream (memset, or by
    the last block of a one-launch call), never by the host."""
    fn, plain = _int8_quantizers(dev, 32)[kind]
    static_x = _x_int8(dev, rows, k, "randn", seed=7)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn(static_x)                    # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = fn(static_x)
    for seed, data in ((8, "randn"), (9, "binades"), (10, "zero_row")):
        static_x.copy_(_x_int8(dev, rows, k, data, seed=seed))
        graph.replay()
        torch.cuda.synchronize()
        assert _int8_q_equal(kind, out, plain(static_x))


@pytest.mark.parametrize("m,n,k", [(4, 200, 512), (70, 64, 1024), (129, 130, 96),
                                   (1, 40, 96), (64, 48, 4096)])
def test_gemm_int8_rank1_kernel(dev, m, n, k):
    g = torch.Generator(device=dev).manual_seed(2)
    a = torch.randint(-96, 97, (k, m), generator=g, device=dev, dtype=torch.int8)
    b = torch.randint(-96, 97, (n, k), generator=g, device=dev, dtype=torch.int8)
    sa = torch.rand(m, generator=g, device=dev)
    sb = torch.rand(n, generator=g, device=dev)
    for a_kmajor, b_kmajor in ((True, False), (False, False), (True, True)):
        aa = a if a_kmajor else a.T.contiguous()
        bb = b.T.contiguous() if b_kmajor else b
        got = G.gemm_int8_rank1(aa, bb, sa, sb, 0.75, a_kmajor=a_kmajor,
                                b_kmajor=b_kmajor)
        want = G.gemm_int8_rank1_plain(a.T, b, sa, sb, 0.75)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def _k3_operands(dev, m, n, k, order, seed=0):
    """Random int8 a' [K, M] and b' [N, K] with |values| <= 127, in the
    storage of ``order``: "nk" ([M, K], [N, K]), "kmajor" ([K, M], [N, K]),
    "kk" ([K, M], [K, N]); returns (a, b, a', b', sa, sb)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    at = torch.randint(-127, 128, (k, m), generator=g, device=dev, dtype=torch.int8)
    b = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
    sa = torch.rand(m, generator=g, device=dev) + 0.01
    sb = torch.rand(n, generator=g, device=dev) + 0.01
    aa = at.T.contiguous() if order == "nk" else at
    bb = b.T.contiguous() if order == "kk" else b
    return aa, bb, at, b, sa, sb


def _k3(aa, bb, sa, sb, alpha, order, out_dtype=torch.bfloat16):
    return G.gemm_int8_rank1(aa, bb, sa, sb, alpha, a_kmajor=order != "nk",
                             b_kmajor=order == "kk", out_dtype=out_dtype)


@pytest.mark.parametrize("m", [1, 3, 4, 16, 17, 64, 129, 512])
@pytest.mark.parametrize("order", ["nk", "kmajor", "kk"])
def test_gemm_int8_rank1_both_kernels(dev, order, m):
    """K3's decode (M <= 16) and prefill kernels bitwise against the plain
    version at every N in {8, 1000, 1024, 12288} and K in {32, 96, 4096,
    12288}: ragged tiles, split K, unaligned K-major rows."""
    for n in (8, 1000, 1024, 12288):
        for k in (32, 96, 4096, 12288):
            aa, bb, at, b, sa, sb = _k3_operands(dev, m, n, k, order, seed=m + n + k)
            got = _k3(aa, bb, sa, sb, 0.75, order)
            want = G.gemm_int8_rank1_plain(at.T, b, sa, sb, 0.75)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (m, n, k, order, int((got != want).sum()))


@pytest.mark.parametrize("m", [4, 512])
@pytest.mark.parametrize("order", ["nk", "kmajor", "kk"])
@pytest.mark.parametrize("device_alpha", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_gemm_int8_rank1_out_dtype_and_alpha(dev, out_dtype, device_alpha, order, m):
    """bf16 and fp32 outputs, alpha a host number or a CUDA tensor: bitwise
    the plain version; the fp32 output rounds to the bf16 one."""
    aa, bb, at, b, sa, sb = _k3_operands(dev, m, 1000, 4096, order, seed=3)
    alpha = torch.tensor([0.37], device=dev) if device_alpha else 0.37
    got = _k3(aa, bb, sa, sb, alpha, order, out_dtype)
    want = G.gemm_int8_rank1_plain(at.T, b, sa, sb, alpha, out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and torch.equal(got, want)
    if out_dtype == torch.float32:
        assert torch.equal(got.to(torch.bfloat16), _k3(aa, bb, sa, sb, alpha, order))


@pytest.mark.parametrize("order", ["kmajor", "kk"])
def test_gemm_int8_rank1_split_k_repeats(dev, order):
    """At a split-K shape (16 slices of K = 4096 over N = 1024) two launches
    give the same bits, and the kernel leaves its arrival counters zero."""
    aa, bb, at, b, sa, sb = _k3_operands(dev, 4, 1024, 4096, order, seed=4)
    kc, splits = G.decode_split(1024, 4096, torch.cuda.get_device_properties(dev)
                                .multi_processor_count, order == "kk")
    assert splits > 1
    y1, y2 = _k3(aa, bb, sa, sb, 0.5, order), _k3(aa, bb, sa, sb, 0.5, order)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(y1, G.gemm_int8_rank1_plain(at.T, b, sa, sb, 0.5))
    assert all(int(c.abs().sum()) == 0 for c in G._counters.values())


def test_gemm_int8_rank1_refuses_what_it_cannot_take(dev):
    """A layout neither kernel takes raises and launches nothing; there is
    no fallback to the plain version."""
    aa, bb, _, _, sa, sb = _k3_operands(dev, 64, 96, 256, "nk", seed=5)
    dispatch.reset_launch_counts()
    strided = aa[:, ::2]                       # neither K-contiguous nor K-major
    for fn in (lambda: G.gemm_int8_rank1(strided, bb[:, ::2], sa, sb, 1.0, a_kmajor=False,
                                         b_kmajor=False),
               lambda: G.gemm_int8_rank1(aa, bb, sa, sb, 1.0, a_kmajor=False, b_kmajor=False,
                                         out_dtype=torch.float16)):
        with pytest.raises(ValueError):
            fn()
    assert dispatch.launch_counts["gemm_int8_rank1"] == 0


@pytest.mark.parametrize("m", [4, 64])
def test_k2_k3_equal_k4_at_deficit_3(dev, m):
    """The main path's kernels K2 (activation) and K3 equal the fp4 GEMM K4
    on the same MXFP4 values in every row whose deficit is <= 3, through
    K3's and K4's decode kernels (M = 4) and their prefill kernels (M =
    64)."""
    h = qt.hadamard_matrix(32, device=dev)
    x, w = _x(dev, m, 4096, seed=6), _x(dev, 1024, 4096, seed=7, scale=4096 ** -0.5)
    ai, sa, sbytes = Q.quantize_mx_int8(x, h, rot_size=32)
    xqt, xst = Q.quantize_mx(x, h, rot_size=32, layout="kmajor")
    wqt, wst = Q.quantize_mx(w, h, rot_size=32, layout="kmajor")
    wi, sb, dw = I8.prepare_weight_int8(wqt, wst)
    y3 = I8.matmul_mxf4_bf16_int8_kmajor(ai, wi, sa, sb, 1.0)
    y4, dec, pre = _k4(xqt, wqt, xst, wst, 1.0)
    assert (dec, pre) == ((1, 0) if m <= G.DECODE_M else (0, 1))
    se = sbytes.to(torch.int32)
    ai1 = I8.encode_int8(xqt, xst, kmajor=True)[0]      # K1's codes, encoded
    rows = ((se.amax(0) - se).amax(0) <= 3) & (sbytes == xst).all(0) & (ai == ai1).all(0)
    torch.cuda.synchronize()
    assert int(dw) <= 3 and float(rows.float().mean()) >= 0.9
    assert torch.equal(y3[rows], y4[rows])


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_gemm_fp4_kernels_out_dtype(dev, out_dtype):
    """K4 and K7 in bf16 and fp32 bitwise against their plain versions."""
    h = qt.hadamard_matrix(32, device=dev)
    x, w = _x(dev, 65, 1024, seed=8), _x(dev, 70, 1024, seed=9, scale=0.05)
    xqt, xst = Q.quantize_mx(x, h, rot_size=32, layout="kmajor")
    wqt, wst = Q.quantize_mx(w, h, rot_size=32, layout="kmajor")
    got = G.gemm_fp4_mx(xqt, wqt, xst, wst, 0.625, layout="kmajor", out_dtype=out_dtype)
    assert got.dtype == out_dtype and torch.equal(got, G.gemm_fp4_mx_plain(
        xqt, wqt, xst, wst, 0.625, layout="kmajor", out_dtype=out_dtype))
    gs = torch.tensor(40.0, device=dev)
    nqt, nst = Q.quantize_nv(x, h, gs, rot_size=32, layout="kmajor")
    mqt, mst = Q.quantize_nv(w, h, gs, rot_size=32, layout="kmajor")
    al = torch.tensor([0.625], device=dev)
    got = qt.matmul_nvf4_bf16_kmajor(nqt, mqt, nst, mst, al, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and torch.equal(got, G.gemm_fp4_nv_plain(
        nqt, mqt, nst, mst, al, layout="kmajor", out_dtype=out_dtype))


@pytest.mark.parametrize("m,n,k", [(4, 96, 512), (65, 70, 1024), (1, 33, 96)])
def test_gemm_fp4_kernel_and_int8_agree(dev, m, n, k):
    h = qt.hadamard_matrix(32, device=dev)
    xqt, xst = Q.quantize_mx(_x(dev, m, k, seed=3), h, rot_size=32, layout="kmajor")
    wqt, wst = Q.quantize_mx(_x(dev, n, k, seed=4), h, rot_size=32, layout="kmajor")
    got = G.gemm_fp4_mx(xqt, wqt, xst, wst, 1.0, layout="kmajor")
    assert torch.equal(got, G.gemm_fp4_mx_plain(xqt, wqt, xst, wst, 1.0,
                                                layout="kmajor"))
    xc, xsc = Q.quantize_mx(_x(dev, m, k, seed=3), h, rot_size=32,
                            layout="kmajor_codes")
    assert torch.equal(G.gemm_fp4_mx(xc, wqt, xsc, wst, 1.0, layout="kmajor_codes"),
                       G.gemm_fp4_mx_plain(xc, wqt, xsc, wst, 1.0,
                                           layout="kmajor_codes"))
    xq, xs = Q.quantize_mx(_x(dev, m, k, seed=3), h, rot_size=32)
    wq, ws = Q.quantize_mx(_x(dev, n, k, seed=4), h, rot_size=32)
    tn = qt.matmul_mxf4_bf16_tn(xq, wq, qt.to_blocked(xs), qt.to_blocked(ws), 1.0)
    assert torch.equal(tn, G.gemm_fp4_mx_plain(xq, wq, xs[:m, :k // 32],
                                               ws[:n, :k // 32], 1.0, layout="tn"))
    ai, sa, da = I8.encode_int8(xqt, xst, kmajor=True)
    wi, sb, dw = I8.prepare_weight_int8(wqt, wst)
    assert max(int(da), int(dw)) <= 3
    assert torch.equal(I8.matmul_mxf4_bf16_int8_kmajor(ai, wi, sa, sb, 1.0), got)


@pytest.mark.parametrize("layout", ["rowmajor", "kmajor"])
@pytest.mark.parametrize("rot,shape", [(16, (70, 640)), (32, (70, 640)),
                                       (64, (70, 640)), (128, (70, 640)),
                                       (16, (33, 48)), (32, (1, 96))] + FP4_Q_CASES[6:])
@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_quantize_nv_kernel(dev, method, rot, shape, layout):
    """Codes and scale bytes bitwise the ordered plain version (the
    kernel's orders of sums); against the plain version (cuBLAS's order)
    each within a 1e-4 mismatch rate."""
    x, h = _x(dev, *shape, scale=25.0), qt.hadamard_matrix(rot, device=dev)
    gs = torch.tensor(2.5, device=dev)
    got = Q.quantize_nv(x, h, gs, rot_size=rot, method=method, layout=layout)
    want = Q.quantize_nv_plain(x, h, gs, rot_size=rot, method=method, layout=layout)
    torch.cuda.synchronize()
    assert _bitwise(got, E.fused_quantize_nv_ordered_plain(x, h, gs, rot_size=rot,
                                                           method=method, layout=layout))
    assert got[1].shape == want[1].shape and got[0].shape == want[0].shape
    assert (got[1] != want[1]).float().mean() <= 1e-4
    assert (_codes(got[0], layout) != _codes(want[0], layout)).float().mean() <= 1e-4


@pytest.mark.parametrize("rot,shape,data", [(16, (13, 1536), "randn"), (32, (4, 4096), "randn"),
                                            (128, (13, 1536), "randn"), (16, (9, 48), "randn")]
                         + INT8_Q_CASES[4:])
@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_quantize_nv_int8_kernel(dev, method, rot, shape, data):
    x, h = _x_int8(dev, *shape, data), qt.hadamard_matrix(rot, device=dev)
    gs = torch.tensor([2688.0 / 5.0], device=dev)
    ga, gs_, gb = Q.quantize_nv_int8(x, h, gs, rot_size=rot, method=method)
    wa, ws, wb = Q.quantize_nv_int8_plain(x, h, gs, rot_size=rot, method=method)
    torch.cuda.synchronize()
    assert (gb != wb).float().mean() <= 1e-4
    same = (gb == wb).all(0)
    assert torch.equal(ga[:, same], wa[:, same]) and torch.equal(gs_[same], ws[same])


@pytest.mark.parametrize("m,n,k", [(4, 96, 512), (65, 70, 1024), (1, 33, 48),
                                   (64, 48, 4096)])
def test_gemm_fp4_nv_kernel(dev, m, n, k):
    h = qt.hadamard_matrix(16, device=dev)
    one = torch.tensor(1.0, device=dev)
    xqt, xst = Q.quantize_nv(_x(dev, m, k, seed=3), h, one, rot_size=16, layout="kmajor")
    wqt, wst = Q.quantize_nv(_x(dev, n, k, seed=4, scale=0.05), h,
                             torch.tensor(448.0 * 6 / 0.2, device=dev), rot_size=16,
                             layout="kmajor")
    alpha = torch.tensor([0.37], device=dev)
    got = G.gemm_fp4_nv(xqt, wqt, xst, wst, alpha, layout="kmajor")
    assert torch.equal(got, G.gemm_fp4_nv_plain(xqt, wqt, xst, wst, alpha,
                                                layout="kmajor"))
    tn = qt.matmul_nvf4_bf16_tn(xqt.T.contiguous(), wqt.T.contiguous(),
                                xst.T.contiguous(), wst.T.contiguous(), 0.37)
    torch.cuda.synchronize()
    assert torch.equal(tn, got)


# K4: the split-K decode kernel (kmajor, M <= 16) and the prefill kernel
# (gemm_fp4_prefill.cuh, K7's, templated on the format)

def _mx_operands(dev, m, n, k, seed, lo=120, hi=136):
    """Random K-major MXFP4 operands: packed codes (every code) [K/2, M] /
    [K/2, N] and e8m0 scale bytes in [lo, hi) [K/32, M] / [K/32, N]; with
    the default bytes every fp64 sum of group terms is exact up to K =
    12288 (30 binades + 13 bits of a group sum + 9 bits of 384 groups)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    codes = [torch.randint(0, 256, (k // 2, r), generator=g, device=dev, dtype=torch.uint8)
             for r in (m, n)]
    scales = [torch.randint(lo, hi, (k // 32, r), generator=g, device=dev, dtype=torch.uint8)
              for r in (m, n)]
    return codes[0], codes[1], scales[0], scales[1]


def _k4(a, b, a_sf, b_sf, alpha, layout="kmajor", out_dtype=torch.bfloat16):
    """K4 and the launches of its decode and prefill kernels."""
    names = ("gemm_fp4_mx_decode", "gemm_fp4_mx_prefill")
    before = [dispatch.launch_counts[k] for k in names]
    y = G.gemm_fp4_mx(a, b, a_sf, b_sf, alpha, layout=layout, out_dtype=out_dtype)
    return (y, *(dispatch.launch_counts[k] - b0 for k, b0 in zip(names, before)))


def _tn(ops):
    """K-major operands -> the row-major (tn) layout."""
    return tuple(t.T.contiguous() for t in ops)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,n", [(4096, 1024), (4096, 4096), (4096, 12288), (12288, 4096),
                                 (4096, 1030)])
@pytest.mark.parametrize("m", [1, 3, 4, 8, 16])
def test_gemm_fp4_mx_decode_kernel(dev, m, n, k, out_dtype):
    """K4's split-K decode kernel (M <= 16, K-major; every MB bucket)
    bitwise against the group fold and the plain version, alpha on the
    card, at the decode shapes and at N % 4 != 0 (byte loads); the prefill
    kernel (the tn layout) gives the same bits, since the fp64 sums are
    exact."""
    ops = _mx_operands(dev, m, n, k, seed=m + n + k)
    alpha = torch.tensor([0.37], device=dev)
    got, dec, pre = _k4(*ops, alpha, out_dtype=out_dtype)
    fold = E.gemm_fp4_mx_groupfold_plain(*ops, alpha, layout="kmajor", out_dtype=out_dtype)
    want = G.gemm_fp4_mx_plain(*ops, alpha, layout="kmajor", out_dtype=out_dtype)
    tn, tn_dec, tn_pre = _k4(*_tn(ops), alpha, "tn", out_dtype)
    torch.cuda.synchronize()
    assert (dec, pre, tn_dec, tn_pre) == (1, 0, 0, 1) and got.dtype == out_dtype
    assert torch.equal(got, fold) and torch.equal(got, want) and torch.equal(tn, got)


@pytest.mark.parametrize("m", [4, 16, 64])
def test_gemm_fp4_mx_kernels_exact_where_an_fp32_chain_rounds(dev, m):
    """Group scales spread over ~29 binades, where the fp32 chain K4 ran
    before rounds: the decode kernel (M <= 16) or the prefill kernel, and
    the prefill kernel in the tn layout, equal the plain version bit for
    bit."""
    ops = tuple(t.to(dev) for t in mx_spread(m, 200, 4096, seed=m))
    for od in (torch.bfloat16, torch.float32):
        want = G.gemm_fp4_mx_plain(*ops, 0.37, layout="kmajor", out_dtype=od)
        got, dec, pre = _k4(*ops, 0.37, out_dtype=od)
        tn, _, tn_pre = _k4(*_tn(ops), 0.37, "tn", od)
        torch.cuda.synchronize()
        assert (dec, pre) == ((1, 0) if m <= G.DECODE_M else (0, 1)) and tn_pre == 1
        assert torch.equal(got, want) and torch.equal(tn, want)


@pytest.mark.parametrize("m", [4, 64])
def test_gemm_fp4_mx_kernels_where_the_bf16_dequant_saturates(dev, m):
    """a's scale bytes 240-254, b's 0-14: the plain version's bf16 dequant
    saturates to inf at bytes 253-254, the kernels keep the exact terms
    and equal the group fold (exact here) in both layouts."""
    ops = tuple(t.to(dev) for t in mx_spread(m, 72, 1024, seed=8, a_bytes=(240, 255),
                                             b_bytes=(0, 15)))
    fold = E.gemm_fp4_mx_groupfold_plain(*ops, 0.37, layout="kmajor")
    got, dec, pre = _k4(*ops, 0.37)
    tn, _, tn_pre = _k4(*_tn(ops), 0.37, "tn")
    plain = G.gemm_fp4_mx_plain(*ops, 0.37, layout="kmajor")
    torch.cuda.synchronize()
    assert (dec, pre) == ((1, 0) if m <= G.DECODE_M else (0, 1)) and tn_pre == 1
    assert bool(torch.isfinite(fold.float()).all())
    assert torch.equal(got, fold) and torch.equal(tn, fold)
    assert not bool(torch.isfinite(plain.float()).all())


def _mx_layout(ops, layout):
    """K-major operands -> ``layout``: as they are, row-major (tn), or with
    the activation as unpacked codes [K, M] (kmajor_codes)."""
    if layout == "tn":
        return _tn(ops)
    if layout == "kmajor_codes":
        return (E.unpack_codes(ops[0].T).T.contiguous().to(torch.uint8), *ops[1:])
    return ops


@pytest.mark.parametrize("m", [17, 64])
def test_gemm_fp4_mx_above_16_rows_tn_and_codes_run_the_prefill_kernel(dev, m):
    """M > 16 in the K-major layout, the row-major (tn) layout at any M and
    unpacked activation codes at any M run the prefill kernel: no decode
    launch, bitwise the plain version."""
    ops = _mx_operands(dev, m, 200, 4096, seed=m)
    got, dec, pre = _k4(*ops, 0.37)
    want = G.gemm_fp4_mx_plain(*ops, 0.37, layout="kmajor")
    four = (ops[0][:, :4].contiguous(), ops[1], ops[2][:, :4].contiguous(), ops[3])
    tn, tn_dec, tn_pre = _k4(*_tn(four), 0.37, "tn")
    codes, c_dec, c_pre = _k4(*_mx_layout(four, "kmajor_codes"), 0.37, "kmajor_codes")
    torch.cuda.synchronize()
    assert (dec, pre, tn_dec, tn_pre, c_dec, c_pre) == (0, 1, 0, 1, 0, 1)
    assert torch.equal(got, want) and torch.equal(tn, want[:4]) and torch.equal(codes, want[:4])


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", ["kmajor", "tn", "kmajor_codes"])
@pytest.mark.parametrize("m,k,n", [(17, 4128, 1024), (17, 4128, 4104), (64, 4128, 1024),
                                   (64, 4128, 4104), (512, 4128, 1024), (512, 4128, 4104),
                                   (305, 1056, 33), (512, 4096, 12288)])
def test_gemm_fp4_mx_prefill_kernel(dev, m, k, n, layout, out_dtype):
    """K4's prefill kernel bitwise against its plain version and the group
    fold, alpha on the card and as a number: ragged M (vector and byte
    loads), N and K (K % 64 == 32: the last slab holds one 32-group), the
    three layouts, bf16 and fp32, on its 64 x 32 tile (grids under two
    blocks an SM of 64 x 64) and its 64 x 64 tile."""
    ops = _mx_operands(dev, m, n, k, seed=m + n + k)
    alpha = torch.tensor([0.37], device=dev)
    want = G.gemm_fp4_mx_plain(*ops, alpha, layout="kmajor", out_dtype=out_dtype)
    fold = E.gemm_fp4_mx_groupfold_plain(*ops, alpha, layout="kmajor", out_dtype=out_dtype)
    args = _mx_layout(ops, layout)
    got, dec, pre = _k4(*args, alpha, layout, out_dtype)
    by_value, _, pre_v = _k4(*args, 0.37, layout, out_dtype)
    torch.cuda.synchronize()
    assert (dec, pre, pre_v) == (0, 1, 1) and got.dtype == out_dtype
    assert torch.equal(got, want) and torch.equal(got, fold) and torch.equal(by_value, want)


@pytest.mark.parametrize("m,k,n,off", [(17, 4096, 1024, 0), (6521, 4096, 1024, 0),
                                       (6522, 2048, 1536, 0), (6523, 4096, 1024, 0),
                                       (6524, 4096, 1024, 0), (45, 1536, 2048, 3),
                                       (64, 2048, 1536, 1)])
def test_gemm_fp4_mx_kmajor_prefill_pads_an_activation_it_cannot_word_load(dev, m, k, n, off):
    """A K-major activation of M % 4 != 0 rows, or a column slice at a base
    that is no multiple of 4, is copied into zero-padded rows of a multiple
    of 4 before the prefill kernel: the output is [M, N], contiguous,
    bitwise the plain version, and the operands are left as they were."""
    at, bt, ast, bst = _mx_operands(dev, m + off, n, k, seed=m + off)
    ops = (at[:, off:], bt, ast[:, off:], bst)
    assert G.word_rows(ops[0].T, m) == (m % 4 == 0 and off == 0)
    before = [t.clone() for t in ops]
    want = G.gemm_fp4_mx_plain(*(t.contiguous() for t in ops), 0.37, layout="kmajor")
    got, dec, pre = _k4(*ops, 0.37)
    torch.cuda.synchronize()
    assert (dec, pre) == (0, 1) and got.shape == (m, n) and got.is_contiguous()
    assert torch.equal(got, want) and all(torch.equal(t, u) for t, u in zip(ops, before))


# K4's warp-specialised prefill kernel (gemm_fp4_prefill_wg.cuh behind
# gemm_fp4_mx_wg.cu; not in the library, built here on demand) against K4
# (whose K-major calls above 16 rows run the prefill kernel), the plain
# version and the group fold: today's grid, then ragged M (M % 4 = 1, 2, 3),
# K of 1536 to 12288 and N of 33 to 12288, on each of its 128 x 128,
# 128 x 64 and 128 x 32 tiles
WG_CASES = [(17, 4128, 1024), (17, 4128, 4104), (64, 4128, 1024), (64, 4128, 4104),
            (512, 4128, 1024), (512, 4128, 4104), (305, 1056, 33), (512, 4096, 12288),
            (63, 2048, 1536), (130, 1536, 33), (345, 4096, 1024), (345, 12288, 4104),
            (1596, 2048, 12288), (6523, 4096, 1536), (6522, 12288, 1024)]


@pytest.fixture(scope="module")
def wg_lib(tmp_path_factory):
    """The warp-specialised kernel's library, compiled once for the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from qutlass_tpu_torch.tools import time_mx_prefill_wg as W
    return W.build(tmp_path_factory.mktemp("wg"))["this"]


def _wg(lib, ops, alpha, out_dtype=torch.bfloat16):
    from qutlass_tpu_torch.tools import time_mx_prefill_wg as W
    return W.call(torch, lib, *ops, alpha, out_dtype)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", WG_CASES)
def test_gemm_fp4_mx_prefill_wg_kernel(dev, wg_lib, m, k, n, out_dtype):
    """The warp-specialised prefill kernel bitwise K4's prefill kernel, the
    plain version and the group fold, alpha on the card and as a number."""
    ops = _mx_operands(dev, m, n, k, seed=m + n + k)
    alpha = torch.tensor([0.37], device=dev)
    want = G.gemm_fp4_mx_plain(*ops, alpha, layout="kmajor", out_dtype=out_dtype)
    fold = E.gemm_fp4_mx_groupfold_plain(*ops, alpha, layout="kmajor", out_dtype=out_dtype)
    old = G.gemm_fp4_mx(*ops, alpha, layout="kmajor", out_dtype=out_dtype)
    got = _wg(wg_lib, ops, alpha, out_dtype)
    by_value = _wg(wg_lib, ops, 0.37, out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and torch.equal(got, old) and torch.equal(got, want)
    assert torch.equal(got, fold) and torch.equal(by_value, want)


@pytest.mark.parametrize("off", [1, 2, 3, 5])
@pytest.mark.parametrize("m,k,n", [(17, 2048, 1536), (45, 1536, 2048), (345, 4096, 1024)])
def test_gemm_fp4_mx_prefill_wg_kernel_on_a_column_slice(dev, wg_lib, m, k, n, off):
    """An activation that is a column slice of a larger K-major tensor at
    a base that is no multiple of 4 (an expert's rows in an LFM2 prefill):
    aligned word loads and a funnel shift, bitwise K4 and the plain
    version."""
    at, bt, ast, bst = _mx_operands(dev, m + off + 7, n, k, seed=off + m)
    ops = (at[:, off:off + m], bt, ast[:, off:off + m], bst)
    want = G.gemm_fp4_mx_plain(*(t.contiguous() for t in ops), 0.37, layout="kmajor")
    old = G.gemm_fp4_mx(*ops, 0.37, layout="kmajor")
    got = _wg(wg_lib, ops, 0.37)
    torch.cuda.synchronize()
    assert torch.equal(got, old) and torch.equal(got, want)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,n,case", [(64, 200, "round"), (305, 72, "round_nan"),
                                      (345, 1024, "round_nan"), (512, 4104, "round"),
                                      (17, 72, "extreme"), (130, 4104, "extreme")])
def test_gemm_fp4_mx_prefill_wg_kernel_adversarial_bytes(dev, wg_lib, m, n, case, out_dtype):
    """Where the fp64 sums round (``mx_adversarial``) and at scale bytes
    0, 253, 254 and 255 (``extreme``): the warp-specialised kernel folds in
    the prefill kernel's order, so it equals K4 and the group fold bit for
    bit, NaN positions included."""
    if case == "extreme":
        ops = tuple(t.to(dev) for t in _mx_extreme(m, n, 1024, seed=m))
    else:
        ops = tuple(t.to(dev) for t in mx_adversarial(m, n, 4096, seed=m,
                                                      special=case == "round_nan"))
    alpha = torch.tensor([0.37], device=dev)
    want = E.gemm_fp4_mx_groupfold_plain(*ops, alpha, layout="kmajor", out_dtype=out_dtype)
    old = G.gemm_fp4_mx(*ops, alpha, layout="kmajor", out_dtype=out_dtype)
    got = _wg(wg_lib, ops, alpha, out_dtype)
    torch.cuda.synchronize()
    assert nan_equal(got, want) and nan_equal(got, old)
    assert bool(torch.isnan(want.float()).any()) == (case != "round")


@pytest.mark.parametrize("device_alpha", [True, False])
def test_gemm_fp4_mx_prefill_wg_kernel_repeats_and_replays_in_a_cuda_graph(dev, wg_lib,
                                                                           device_alpha):
    """Repeated launches of the warp-specialised kernel give the same bits;
    one captured in a CUDA graph and replayed on new inputs (and a new
    device alpha) equals the plain version: no workspace, no counters."""
    ops = list(_mx_operands(dev, 345, 1024, 4096, seed=21))
    alpha = torch.tensor([0.37], device=dev) if device_alpha else 0.37
    first = _wg(wg_lib, ops, alpha)
    for _ in range(3):
        assert torch.equal(_wg(wg_lib, ops, alpha), first)
    torch.cuda.synchronize()
    assert torch.equal(first, G.gemm_fp4_mx_plain(*ops, alpha, layout="kmajor"))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        _wg(wg_lib, ops, alpha)                              # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = _wg(wg_lib, ops, alpha)
    for seed in (22, 23):
        for t, new in zip(ops, _mx_operands(dev, 345, 1024, 4096, seed=seed)):
            t.copy_(new)
        if device_alpha:
            alpha.fill_(0.25 * seed)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, G.gemm_fp4_mx_plain(*ops, alpha, layout="kmajor"))


def test_gemm_fp4_mx_prefill_wg_kernel_refuses_what_it_cannot_take(dev, wg_lib):
    """The warp-specialised kernel takes K-major packed operands and scales
    of unit stride along M and N, and K % 32 == 0: another stride on any of
    the four, or K = 48, returns an error and writes nothing."""
    at, bt, ast, bst = _mx_operands(dev, 64, 128, 512, seed=5)
    for i in range(4):
        ops = [at, bt, ast, bst]
        ops[i] = ops[i].repeat(1, 2)[:, ::2]
        with pytest.raises(RuntimeError):
            _wg(wg_lib, ops, 1.0)
    k48 = (at[:24], bt[:24], ast[:1], bst[:1])
    with pytest.raises(RuntimeError):
        _wg(wg_lib, k48, 1.0)


def _mx_extreme(m, n, k, seed):
    """K-major operands on the card with a's scale bytes 240-254 and b's
    0-14 (the plain version's bf16 dequant saturates at 253-254, the fold
    stays exact) and NaN bytes (255) planted in a row and a column."""
    at, bt, ast, bst = (t.clone() for t in mx_spread(m, n, k, seed, a_bytes=(240, 255),
                                                     b_bytes=(0, 15)))
    ast[1, 2], bst[k // 32 - 1, n - 1] = 255, 255
    return at, bt, ast, bst


# (M, N, case, layout): kmajor only above 16 rows, where the prefill kernel runs
MX_ADVERSARIAL = [(4, 40, "round_nan", "tn"), (4, 40, "round_nan", "kmajor_codes")] + [
    (m, n, case, layout) for m, n, case in ((64, 200, "round"), (305, 72, "round_nan"),
                                            (512, 1024, "round_nan"), (512, 4104, "round"),
                                            (17, 72, "extreme"), (64, 4104, "extreme"),
                                            (512, 1024, "extreme"))
    for layout in ("kmajor", "tn", "kmajor_codes")]


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,n,case,layout", MX_ADVERSARIAL)
def test_gemm_fp4_mx_prefill_kernel_adversarial_bytes(dev, m, n, case, layout, out_dtype):
    """Where the fp64 sums round (``mx_adversarial``) no order is bitwise
    against the fp64 product: the prefill kernel (tn and kmajor_codes at
    any M, kmajor above 16 rows) equals the group fold in ascending k
    (``gemm_fp4_mx_groupfold_plain``, which K16 runs too) bit for bit, NaN
    positions included, and the fp64 product differs.  At scale bytes 0,
    253, 254 and 255 (``extreme``) it equals the fold, which is finite
    where the plain version's bf16 dequant saturates, NaN aside."""
    if case == "extreme":
        ops = tuple(t.to(dev) for t in _mx_extreme(m, n, 1024, seed=m))
    else:
        ops = tuple(t.to(dev) for t in mx_adversarial(m, n, 4096, seed=m,
                                                      special=case == "round_nan"))
    alpha = torch.tensor([0.37], device=dev)
    want = E.gemm_fp4_mx_groupfold_plain(*ops, alpha, layout="kmajor", out_dtype=out_dtype)
    plain = G.gemm_fp4_mx_plain(*ops, alpha, layout="kmajor", out_dtype=out_dtype)
    got, _, pre = _k4(*_mx_layout(ops, layout), alpha, layout, out_dtype)
    torch.cuda.synchronize()
    assert pre == 1 and nan_equal(got, want)
    nan = torch.isnan(want.float())
    assert bool(nan.any()) == (case != "round")
    if case == "extreme":
        assert bool(torch.isfinite(want[~nan].float()).all())
        assert not bool(torch.isfinite(plain[~nan].float()).all())
    else:
        assert not torch.equal(plain[~nan], want[~nan])


@pytest.mark.parametrize("device_alpha", [True, False])
def test_gemm_fp4_mx_prefill_kernel_repeats_and_replays_in_a_cuda_graph(dev, device_alpha):
    """Repeated launches give the same bits; a launch captured in a CUDA
    graph and replayed on new inputs (and a new device alpha) equals the
    plain version: no workspace, no counters, alpha read on the card or
    passed by value."""
    ops = list(_mx_operands(dev, 512, 1024, 4096, seed=11))
    alpha = torch.tensor([0.37], device=dev) if device_alpha else 0.37
    first = G.gemm_fp4_mx(*ops, alpha, layout="kmajor")
    for _ in range(3):
        assert torch.equal(G.gemm_fp4_mx(*ops, alpha, layout="kmajor"), first)
    torch.cuda.synchronize()
    assert torch.equal(first, G.gemm_fp4_mx_plain(*ops, alpha, layout="kmajor"))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        G.gemm_fp4_mx(*ops, alpha, layout="kmajor")          # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = G.gemm_fp4_mx(*ops, alpha, layout="kmajor")
    for seed in (12, 13):
        for t, new in zip(ops, _mx_operands(dev, 512, 1024, 4096, seed=seed)):
            t.copy_(new)
        if device_alpha:
            alpha.fill_(0.25 * seed)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, G.gemm_fp4_mx_plain(*ops, alpha, layout="kmajor"))


def test_gemm_fp4_mx_prefill_kernel_refuses_what_it_cannot_take(dev):
    """Above 16 rows and in the tn and kmajor_codes layouts: K % 32 != 0,
    operands that disagree on K, empty operands and codes of another type
    raise and launch nothing; there is no fallback."""
    at, bt, ast, bst = _mx_operands(dev, 64, 128, 512, seed=5)
    codes = _mx_layout((at, bt, ast, bst), "kmajor_codes")[0]
    a48, b48, sa48, sb48 = (torch.zeros(shape, dtype=torch.uint8, device=dev)
                            for shape in ((24, 64), (24, 40), (1, 64), (1, 40)))   # K = 48
    e, ec, es = (torch.zeros((r, 0), dtype=torch.uint8, device=dev) for r in (256, 512, 16))
    dispatch.reset_launch_counts()
    for args, layout, exc in (((a48, b48, sa48, sb48), "kmajor", ValueError),
                              ((a48.repeat(2, 1), b48, sa48, sb48), "kmajor_codes", ValueError),
                              ((codes[:-32], bt, ast, bst), "kmajor_codes", ValueError),
                              ((at, e, ast, es), "kmajor", ValueError),
                              ((ec, bt, es, bst), "kmajor_codes", ValueError),
                              ((codes.to(torch.int8), bt, ast, bst), "kmajor_codes", TypeError)):
        with pytest.raises(exc):
            G.gemm_fp4_mx(*args, 1.0, layout=layout)
    assert dispatch.launch_counts["gemm_fp4_mx"] == 0


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_gemm_fp4_mx_decode_kernel_nan_scales(dev, out_dtype):
    """NaN scale bytes (255) give NaN in their row or column, as in the
    plain version and the prefill kernel, at one slice and at several."""
    for k in (512, 8192):
        at, bt, ast, bst = _mx_operands(dev, 4, 200, k, seed=k)
        ast[3, 1], bst[5, 7], bst[k // 32 - 1, 150] = 255, 255, 255
        got, dec, _ = _k4(at, bt, ast, bst, 0.5, out_dtype=out_dtype)
        want = G.gemm_fp4_mx_plain(at, bt, ast, bst, 0.5, layout="kmajor", out_dtype=out_dtype)
        tn = _k4(*_tn((at, bt, ast, bst)), 0.5, "tn", out_dtype)[0]
        torch.cuda.synchronize()
        assert dec == 1 and nan_equal(got, want) and nan_equal(tn, want)
        nan = torch.isnan(got.float())
        assert bool(nan[1].all()) and bool(nan[:, 7].all()) and bool(nan[:, 150].all())
        assert int(nan.sum()) == 200 + 2 * 4 - 2


def test_gemm_fp4_mx_decode_kernel_repeats_bitwise(dev):
    """At many slices, launches land in any order yet give the same bits,
    and leave every arrival counter zero."""
    ops = _mx_operands(dev, 4, 1024, 4096, seed=9)
    assert G.fp4_decode_split(4, 1024, 4096, torch.cuda.get_device_properties(dev)
                              .multi_processor_count, 32)[1] > 1
    first = _k4(*ops, 0.75)[0]
    for _ in range(3):
        assert torch.equal(_k4(*ops, 0.75)[0], first)
    torch.cuda.synchronize()
    assert torch.equal(first, G.gemm_fp4_mx_plain(*ops, 0.75, layout="kmajor"))
    assert all(int(c.abs().sum()) == 0 for c in G._counters.values())


@pytest.mark.parametrize("k,n", [(4096, 12288), (12288, 4096)])
def test_gemm_fp4_mx_decode_kernel_in_cuda_graph(dev, k, n):
    """A decode call captured in a CUDA graph and replayed on new inputs and
    a new device alpha equals the plain version: the counters are reset by
    the kernel and alpha is read on the card, so nothing waits on the
    host."""
    ops = list(_mx_operands(dev, 4, n, k, seed=1))
    alpha = torch.tensor([0.37], device=dev)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        G.gemm_fp4_mx(*ops, alpha, layout="kmajor")          # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = G.gemm_fp4_mx(*ops, alpha, layout="kmajor")
    for seed in (2, 3):
        for t, new in zip(ops, _mx_operands(dev, 4, n, k, seed=seed)):
            t.copy_(new)
        alpha.fill_(0.25 * seed)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, G.gemm_fp4_mx_plain(*ops, alpha, layout="kmajor"))


def test_gemm_fp4_mx_refuses_what_it_cannot_take(dev):
    """At M <= 16 in the K-major layout, a weight or weight scales without
    unit stride along N raise; so do K % 32 != 0 and empty operands.
    Nothing launches and nothing falls back to the prefill kernel or the
    plain version."""
    at, bt, ast, bst = _mx_operands(dev, 4, 128, 512, seed=4)
    wide = torch.zeros((256, 256), dtype=torch.uint8, device=dev)
    swide = torch.zeros((16, 256), dtype=torch.uint8, device=dev)
    a48, b48, sa48, sb48 = (torch.zeros(shape, dtype=torch.uint8, device=dev)
                            for shape in ((32, 24), (40, 24), (32, 1), (40, 1)))   # K = 48
    e, es = (torch.zeros((0, c), dtype=torch.uint8, device=dev) for c in (256, 16))
    dispatch.reset_launch_counts()
    for args, layout in (((at, wide[:, ::2], ast, bst), "kmajor"),
                         ((at, bt, ast, swide[:, ::2]), "kmajor"),
                         ((at, bt.T.contiguous().T, ast, bst), "kmajor"),
                         ((a48, b48, sa48, sb48), "tn"),
                         ((e, bt.T.contiguous(), es, bst.T.contiguous()), "tn")):
        with pytest.raises(ValueError):
            G.gemm_fp4_mx(*args, 1.0, layout=layout)
    assert dispatch.launch_counts["gemm_fp4_mx"] == 0


def _nv_operands(dev, m, n, k, seed):
    """Random K-major NVFP4 operands: packed codes (every code, both zeros
    included) [K/2, M] / [K/2, N] and e4m3 scale bytes [K/16, M] / [K/16,
    N] of either sign with exponent fields 5..11, so that every fp64 sum of
    group terms is exact."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def scales(*shape):
        e = torch.randint(5, 12, shape, generator=g, device=dev, dtype=torch.uint8)
        return torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.uint8) & 0x87 | e << 3
    codes = [torch.randint(0, 256, (k // 2, r), generator=g, device=dev, dtype=torch.uint8)
             for r in (m, n)]
    return codes[0], codes[1], scales(k // 16, m), scales(k // 16, n)


def _k7_decode(at, bt, ast, bst, alpha, out_dtype=torch.bfloat16):
    """K7 in the K-major layout and the launches of its decode kernel."""
    before = dispatch.launch_counts["gemm_fp4_nv_decode"]
    y = G.gemm_fp4_nv(at, bt, ast, bst, alpha, layout="kmajor", out_dtype=out_dtype)
    return y, dispatch.launch_counts["gemm_fp4_nv_decode"] - before


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,n", [(48, 33), (96, 200), (4096, 1024), (4096, 12288), (12288, 4096)])
@pytest.mark.parametrize("m", [1, 4, 13, 16])
def test_gemm_fp4_nv_decode_kernel(dev, m, n, k, out_dtype):
    """K7's split-K decode kernel (M <= 16, K-major) bitwise against its
    plain version, alpha on the card: ragged N and K, unaligned rows (N =
    33), one slice and many."""
    at, bt, ast, bst = _nv_operands(dev, m, n, k, seed=m + n + k)
    alpha = torch.tensor([0.37], device=dev)
    got, launched = _k7_decode(at, bt, ast, bst, alpha, out_dtype)
    want = G.gemm_fp4_nv_plain(at, bt, ast, bst, alpha, layout="kmajor", out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert launched == 1 and got.dtype == out_dtype and torch.equal(got, want)


def _k7_prefill(a, b, a_sf, b_sf, alpha, layout="kmajor", out_dtype=torch.bfloat16):
    """K7 and the launches of its prefill and decode kernels."""
    before = [dispatch.launch_counts[k] for k in ("gemm_fp4_nv_prefill", "gemm_fp4_nv_decode")]
    y = G.gemm_fp4_nv(a, b, a_sf, b_sf, alpha, layout=layout, out_dtype=out_dtype)
    return y, dispatch.launch_counts["gemm_fp4_nv_prefill"] - before[0], \
        dispatch.launch_counts["gemm_fp4_nv_decode"] - before[1]


@pytest.mark.parametrize("m", [17, 64])
def test_gemm_fp4_nv_above_16_rows_and_tn_run_the_prefill_kernel(dev, m):
    """M > 16 and the row-major (tn) layout at any M run the prefill
    kernel: no decode launch, bitwise the plain version."""
    at, bt, ast, bst = _nv_operands(dev, m, 200, 4096, seed=m)
    got, pre, dec = _k7_prefill(at, bt, ast, bst, 0.37)
    want = G.gemm_fp4_nv_plain(at, bt, ast, bst, 0.37, layout="kmajor")
    a4, a4s = at[:, :4].T.contiguous(), ast[:, :4].T.contiguous()
    tn, tn_pre, tn_dec = _k7_prefill(a4, bt.T.contiguous(), a4s, bst.T.contiguous(), 0.37, "tn")
    torch.cuda.synchronize()
    assert (pre, dec, tn_pre, tn_dec) == (1, 0, 1, 0)
    assert torch.equal(got, want) and torch.equal(tn, want[:4])


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", ["kmajor", "tn"])
@pytest.mark.parametrize("m,k,n", [(17, 4112, 200), (64, 4096, 1024), (305, 4112, 33),
                                   (512, 4096, 12288), (1000, 1040, 200), (1000, 1040, 2056)])
def test_gemm_fp4_nv_prefill_kernel(dev, m, k, n, layout, out_dtype):
    """K7's prefill kernel bitwise against its plain version, alpha on the
    card: ragged M (vector and byte loads), N and K (K % 64 == 16), both
    layouts, bf16 and fp32, on its 64 x 32 tile (grids under two blocks
    an SM of 64 x 64) and its 64 x 64 tile (the last two shapes)."""
    ops = _nv_operands(dev, m, n, k, seed=m + n + k)
    alpha = torch.tensor([0.37], device=dev)
    want = G.gemm_fp4_nv_plain(*ops, alpha, layout="kmajor", out_dtype=out_dtype)
    if layout == "tn":
        ops = tuple(t.T.contiguous() for t in ops)
    got, pre, dec = _k7_prefill(*ops, alpha, layout, out_dtype)
    torch.cuda.synchronize()
    assert (pre, dec) == (1, 0) and got.dtype == out_dtype and torch.equal(got, want)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", ["kmajor", "tn"])
@pytest.mark.parametrize("m,n,special", [(64, 200, False), (305, 72, True), (512, 1024, True),
                                         (512, 4096, True)])
def test_gemm_fp4_nv_prefill_kernel_adversarial_bytes(dev, m, n, special, layout, out_dtype):
    """Where the fp64 sums round (terms across ~47 binades) no order is
    bitwise against the fp64 product: the prefill kernel equals the group
    fold in ascending k (``gemm_fp4_nv_groupfold_plain``, the fp4 tile's
    order, which K17 runs) bit for bit, NaN positions included, and the
    fp64 product differs."""
    ops = tuple(t.to(dev) for t in nv_adversarial(m, n, 4096, seed=m, special=special))
    alpha = torch.tensor([0.37], device=dev)
    want = E.gemm_fp4_nv_groupfold_plain(*ops, alpha, layout="kmajor", out_dtype=out_dtype)
    fp64 = G.gemm_fp4_nv_plain(*ops, alpha, layout="kmajor", out_dtype=out_dtype)
    if layout == "tn":
        ops = tuple(t.T.contiguous() for t in ops)
    got, pre, _ = _k7_prefill(*ops, alpha, layout, out_dtype)
    torch.cuda.synchronize()
    assert pre == 1 and nan_equal(got, want)
    nan = torch.isnan(want.float())
    assert bool(nan.any()) == special and not torch.equal(fp64[~nan], want[~nan])


def test_gemm_fp4_nv_prefill_kernel_repeats_and_replays_in_a_cuda_graph(dev):
    """Repeated launches give the same bits; a launch captured in a CUDA
    graph and replayed on new inputs and a new alpha equals the plain
    version (no workspace, no counters, alpha read on the card)."""
    ops = list(_nv_operands(dev, 512, 1024, 4096, seed=11))
    alpha = torch.tensor([0.37], device=dev)
    first = G.gemm_fp4_nv(*ops, alpha, layout="kmajor")
    for _ in range(3):
        assert torch.equal(G.gemm_fp4_nv(*ops, alpha, layout="kmajor"), first)
    torch.cuda.synchronize()
    assert torch.equal(first, G.gemm_fp4_nv_plain(*ops, alpha, layout="kmajor"))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        G.gemm_fp4_nv(*ops, alpha, layout="kmajor")          # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = G.gemm_fp4_nv(*ops, alpha, layout="kmajor")
    for seed in (12, 13):
        for t, new in zip(ops, _nv_operands(dev, 512, 1024, 4096, seed=seed)):
            t.copy_(new)
        alpha.fill_(0.25 * seed)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, G.gemm_fp4_nv_plain(*ops, alpha, layout="kmajor"))


def test_gemm_fp4_nv_prefill_kernel_refuses_what_it_cannot_take(dev):
    """K % 16 != 0 (scales [M, K // 16] then miss the last group's) and
    empty operands raise and launch nothing; there is no fallback."""
    a, b = (torch.zeros((r, 12), dtype=torch.uint8, device=dev) for r in (32, 40))
    sa, sb = (torch.zeros((r, 1), dtype=torch.uint8, device=dev) for r in (32, 40))
    e, es = (torch.zeros((0, 8), dtype=torch.uint8, device=dev),
             torch.zeros((0, 1), dtype=torch.uint8, device=dev))
    dispatch.reset_launch_counts()
    for args in ((a, b, sa, sb), (e, b[:, :8], es, sb), (a[:, :8], e, sa, es)):
        with pytest.raises(ValueError):
            G.gemm_fp4_nv(*args, 1.0, layout="tn")
    assert dispatch.launch_counts["gemm_fp4_nv"] == 0


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_gemm_fp4_nv_decode_kernel_nan_and_zero_scales(dev, out_dtype):
    """NaN scale bytes (0x7F, 0xFF) give NaN in their row or column, zero
    scale bytes (0x00, 0x80) zero terms, as in the plain version and in
    the prefill kernel (the tn layout), at one slice and at several."""
    for k in (512, 8192):
        at, bt, ast, bst = _nv_operands(dev, 4, 200, k, seed=k)
        ast[3, 1], bst[5, 7], bst[k // 16 - 1, 150] = 0x7F, 0xFF, 0x7F
        ast[6, :], bst[:, 11], bst[2, 13], ast[:, 2] = 0, 0, 0x80, 0
        got, launched = _k7_decode(at, bt, ast, bst, 0.5, out_dtype)
        want = G.gemm_fp4_nv_plain(at, bt, ast, bst, 0.5, layout="kmajor", out_dtype=out_dtype)
        tile, pre, _ = _k7_prefill(at.T.contiguous(), bt.T.contiguous(), ast.T.contiguous(),
                                   bst.T.contiguous(), 0.5, "tn", out_dtype)
        torch.cuda.synchronize()
        assert launched == 1 and pre == 1 and nan_equal(got, want)
        nan = torch.isnan(got.float())
        assert bool(nan[1].all()) and bool(nan[:, 7].all()) and bool(nan[:, 150].all())
        assert int(nan.sum()) == 200 + 2 * 4 - 2
        assert bool((got[~nan[:, 0]][:, 11] == 0).all()) and bool((got[2][~nan[2]] == 0).all())
        assert torch.equal(got.view(torch.int16 if out_dtype == torch.bfloat16 else torch.int32),
                           tile.view(torch.int16 if out_dtype == torch.bfloat16 else torch.int32))


def test_gemm_fp4_nv_decode_kernel_repeats_bitwise(dev):
    """At many slices, launches land in any order yet give the same bits,
    and leave every arrival counter zero."""
    at, bt, ast, bst = _nv_operands(dev, 4, 1024, 4096, seed=9)
    kc, splits = G.fp4_decode_split(4, 1024, 4096, torch.cuda.get_device_properties(dev)
                                    .multi_processor_count, 16)
    assert splits > 1
    first = _k7_decode(at, bt, ast, bst, 0.75)[0]
    for _ in range(3):
        assert torch.equal(_k7_decode(at, bt, ast, bst, 0.75)[0], first)
    torch.cuda.synchronize()
    assert torch.equal(first, G.gemm_fp4_nv_plain(at, bt, ast, bst, 0.75, layout="kmajor"))
    assert all(int(c.abs().sum()) == 0 for c in G._counters.values())


@pytest.mark.parametrize("k,n", [(4096, 12288), (12288, 4096)])
def test_gemm_fp4_nv_decode_kernel_in_cuda_graph(dev, k, n):
    """A decode call captured in a CUDA graph and replayed on new inputs
    equals the plain version: the counters are reset by the kernel and
    alpha is read on the card, so nothing waits on the host."""
    ops = list(_nv_operands(dev, 4, n, k, seed=1))
    alpha = torch.tensor([0.37], device=dev)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        G.gemm_fp4_nv(*ops, alpha, layout="kmajor")          # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = G.gemm_fp4_nv(*ops, alpha, layout="kmajor")
    for seed in (2, 3):
        for t, new in zip(ops, _nv_operands(dev, 4, n, k, seed=seed)):
            t.copy_(new)
        alpha.fill_(0.25 * seed)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, G.gemm_fp4_nv_plain(*ops, alpha, layout="kmajor"))


def test_gemm_fp4_nv_decode_kernel_refuses_what_it_cannot_take(dev):
    """At M <= 16 in the K-major layout, a weight or weight scales without
    unit stride along N raise and launch nothing; there is no fallback to
    the tile kernel or the plain version."""
    at, bt, ast, bst = _nv_operands(dev, 4, 128, 512, seed=4)
    wide = torch.zeros((256, 256), dtype=torch.uint8, device=dev)
    swide = torch.zeros((32, 256), dtype=torch.uint8, device=dev)
    dispatch.reset_launch_counts()
    for b, bs in ((wide[:, ::2], bst), (bt, swide[:, ::2]), (bt.T.contiguous().T, bst)):
        with pytest.raises(ValueError):
            G.gemm_fp4_nv(at, b, ast, bs, 1.0, layout="kmajor")
    assert dispatch.launch_counts["gemm_fp4_nv"] == 0


@pytest.mark.parametrize("m,n,k", [(4, 200, 512), (70, 64, 1024)])
def test_nv_int8_gemm_kk_with_device_alpha(dev, m, n, k):
    """K3 in the NV path's order (both operands K-major) with an alpha
    that lives on the card equals its plain version."""
    h = qt.hadamard_matrix(32, device=dev)
    gs = torch.tensor(100.0, device=dev)
    xi, sx, _ = Q.quantize_nv_int8(_x(dev, m, k, seed=5), h, gs, rot_size=32)
    wqt, wst = Q.quantize_nv(_x(dev, n, k, seed=6), h, gs, rot_size=32, layout="kmajor")
    wi, sb = I8.prepare_weight_nv_int8(wqt, wst)
    alpha = 1.0 / (gs * gs)
    got = I8.matmul_mxf4_bf16_int8_kk(xi, wi, sx, sb, alpha)
    torch.cuda.synchronize()
    assert torch.equal(got, G.gemm_int8_rank1_plain(xi.T, wi.T, sx, sb, alpha))


@pytest.mark.parametrize("weight_format", ["int8", "fp4"])
def test_cuda_nv_serving_goes_through_the_kernels(dev, weight_format):
    """The tiny model with NV weights on the card launches K5 and K6 + K3
    (int8 storage) or K5 + K7 (fp4 storage); its logits agree with the
    CPU run of the plain versions."""
    cfg = M.tiny_config()
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    h = qt.hadamard_matrix(32, device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    qp = M.quantize_model_weights(cfg, params, h, fmt="nv", weight_format=weight_format)
    ref, _ = M.prefill(cfg, qp, prompt, h, max_len=16, quantized=True)
    dparams = {k: (v.to(dev) if isinstance(v, torch.Tensor) else
                   [{kk: vv.to(dev) for kk, vv in l.items()} for l in v])
               for k, v in params.items()}
    dispatch.reset_launch_counts()
    dq = M.quantize_model_weights(cfg, dparams, h.to(dev), fmt="nv",
                                  weight_format=weight_format)
    logits, _ = M.prefill(cfg, dq, prompt.to(dev), h.to(dev), max_len=16,
                          quantized=True)
    toks = M.generate(cfg, dq, prompt.to(dev), h.to(dev), steps=3, max_len=16,
                      quantized=True)
    torch.cuda.synchronize()
    counts = dict(dispatch.launch_counts)
    assert counts["quantize_nv"] >= 7 * cfg.num_layers
    if weight_format == "int8":
        assert counts["quantize_nv_int8"] > 0 and counts["gemm_int8_rank1"] > 0
    else:
        assert counts["gemm_fp4_nv"] > 0
    assert tuple(toks.shape) == (2, 3)
    a, b = logits.float().cpu().ravel(), ref.float().ravel()
    assert float(a @ b / (a.norm() * b.norm())) > 0.95


def test_cuda_serving_goes_through_the_kernels(dev):
    """The tiny model on the card: every projection launches the kernels,
    and the logits agree with the CPU run of the plain versions."""
    cfg = M.tiny_config()
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    h = qt.hadamard_matrix(32, device="cpu")
    qp = M.quantize_model_weights(cfg, params, h)
    prompt = torch.randint(0, cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    ref, _ = M.prefill(cfg, qp, prompt, h, max_len=16, quantized=True)
    dparams = {k: (v.to(dev) if isinstance(v, torch.Tensor) else
                   [{kk: vv.to(dev) for kk, vv in l.items()} for l in v])
               for k, v in params.items()}
    dispatch.reset_launch_counts()
    dq = M.quantize_model_weights(cfg, dparams, h.to(dev))
    logits, _ = M.prefill(cfg, dq, prompt.to(dev), h.to(dev), max_len=16,
                          quantized=True)
    toks = M.generate(cfg, dq, prompt.to(dev), h.to(dev), steps=3, max_len=16,
                      quantized=True)
    torch.cuda.synchronize()
    counts = dict(dispatch.launch_counts)
    assert counts["quantize_mx"] >= 7 * cfg.num_layers
    assert counts["quantize_mx_int8"] > 0 and counts["gemm_int8_rank1"] > 0
    assert tuple(toks.shape) == (2, 3)
    a, b = logits.float().cpu().ravel(), ref.float().ravel()
    assert float(a @ b / (a.norm() * b.norm())) > 0.95


# ---------------------------------------------------------------------------
# the QAT training path: K8-K11, K3 in the int8 backward's orders, and
# quartet_linear on the card against the CPU plain path
# ---------------------------------------------------------------------------

def _same_or_nan(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal bits where finite-or-inf, NaN where the other is NaN (a NaN's
    bf16 bits differ between PyTorch's CPU and CUDA casts)."""
    if got.dtype == torch.bfloat16:
        gn, wn = torch.isnan(got), torch.isnan(want)
        return bool(torch.equal(gn, wn)) and torch.equal(
            got.view(torch.int16)[~gn], want.view(torch.int16)[~wn])
    return torch.equal(got, want)


def _edge_tiles(dev, m=128, n=96):
    """bf16 [m, n] whose 32x32 tiles hit the shared exponent's edges:
    amax 0 (byte 127), amax in [2^-120, 2^-119) (byte 0, scale 2^-127),
    in [2^-121, 2^-120) (byte 255, a NaN scale), 2^-123 (wraps to 253:
    the tile quantizes to 0), inf and NaN, and normal tiles."""
    x = _x(dev, m, n, seed=9, scale=3.0).float()
    g = torch.Generator(device=dev).manual_seed(10)
    u = torch.rand((32, 32), generator=g, device=dev) * 2 - 1
    x[0:32, 0:32] = 0.0
    x[32:64, 0:32] = u * 2.0 ** -119.5
    x[32, 0] = 1.5 * 2.0 ** -120
    x[64:96, 0:32] = u * 2.0 ** -120.5
    x[64, 1] = 1.5 * 2.0 ** -121
    x[96:128, 0:32] = u * 2.0 ** -123
    x[0, 40] = float("inf")
    x[40, 70] = float("nan")
    return x.to(torch.bfloat16)


@pytest.mark.parametrize("m,n", [(128, 96), (256, 4096), (32, 32), (4096, 64)])
def test_square_double_kernels(dev, m, n):
    x = _edge_tiles(dev) if (m, n) == (128, 96) else _x(dev, m, n, seed=7, scale=8.0)
    f, e = B.square_double_mxfp8(x)
    fw, ew = B.square_double_mxfp8_plain(x)
    s = B.square_double_scaled(x)
    sw = B.square_double_scaled_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(e, ew) and torch.equal(f, fw)
    assert _same_or_nan(s, sw)


@pytest.mark.parametrize("m,n", [(256, 256), (32, 96), (512, 4096)])
@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_mxfp4_transpose_mxfp8_kernel(dev, m, n, method):
    h = qt.hadamard_matrix(32, device=dev)
    xq, xs = Q.quantize_mx(_x(dev, m, n, seed=8, scale=5.0), h, rot_size=32, method=method)
    sc = xs[:m, :n // 32]                      # a strided slice of the padded buffer
    f, e = B.mxfp4_transpose_mxfp8(xq, sc)
    fw, ew = B.mxfp4_transpose_mxfp8_plain(xq, sc)
    torch.cuda.synchronize()
    assert torch.equal(e, ew) and torch.equal(f, fw)


def test_mxfp4_transpose_mxfp8_kernel_edge_scales(dev):
    """Every e8m0 byte, 0 and 255 included, decodes exactly."""
    g = torch.Generator(device=dev).manual_seed(11)
    m, n = 256, 256
    xq = torch.randint(0, 256, (m, n // 2), generator=g, device=dev, dtype=torch.uint8)
    sc = torch.arange(m * n // 32, device=dev).remainder(256).to(torch.uint8).reshape(m, n // 32)
    f, e = B.mxfp4_transpose_mxfp8(xq, sc)
    fw, ew = B.mxfp4_transpose_mxfp8_plain(xq, sc)
    torch.cuda.synchronize()
    assert torch.equal(e, ew) and torch.equal(f, fw)


def _ulps(got, want):
    ia, ib = got.view(torch.int16).int(), want.view(torch.int16).int()
    return (ia != ib).float().mean().item(), (ia - ib).abs().max().item()


def _mxfp8_operand(dev, rows, k, seed, random_bytes=False):
    """e4m3 bytes [rows, K] and e8m0 scales [rows, K/32]: the
    square-double quantization of a normal bf16 matrix, or random
    non-NaN bytes under random scales near 1."""
    if not random_bytes:
        fp8, rs, _ = qt.backward_bf16_square_double_mxfp8(_x(dev, rows, k, seed=seed, scale=4.0))
        return fp8[:rows], rs[:rows]
    g = torch.Generator(device=dev).manual_seed(seed)
    d = torch.randint(0, 256, (rows, k), generator=g, device=dev, dtype=torch.uint8)
    d[(d & 0x7F) == 0x7F] = 0
    return d, torch.randint(124, 131, (rows, k // 32), generator=g, device=dev,
                            dtype=torch.uint8)


@pytest.mark.parametrize("m,n,k,random_bytes", [(128, 96, 512, False), (70, 33, 96, False),
                                                (256, 256, 4096, False),
                                                (16, 384, 10752, False),
                                                (96, 64, 1024, True)])
@pytest.mark.parametrize("layout", ["tn", "nn"])
def test_gemm_fp8_mx_kernel(dev, m, n, k, random_bytes, layout):
    a, asf = _mxfp8_operand(dev, m, k, 12, random_bytes)
    b, bsf = _mxfp8_operand(dev, n, k, 13, random_bytes)
    aa = a if layout == "tn" else a.T.contiguous()
    alpha = torch.tensor([0.5], device=dev)
    got = G.gemm_fp8_mx(aa, b, asf, bsf, alpha, layout=layout)
    want = G.gemm_fp8_mx_plain(aa, b, asf, bsf, alpha, layout=layout)
    torch.cuda.synchronize()
    rate, ulps = _ulps(got, want)
    assert rate <= 1e-3 and ulps <= 1, (rate, ulps)


def test_gemm_fp8_mx_kernel_public_ops(dev):
    """The reference's byte flow on the card (tests/test_quartet.py's
    shapes): square-double dY, transpose-requantize an MXFP4 operand, the
    NN GEMM; each op launches its kernel and equals its plain version."""
    m, n = 422, 256
    x = _x(dev, m, n, seed=14, scale=5.0)
    eye = torch.eye(32, dtype=torch.bfloat16, device=dev)
    dispatch.reset_launch_counts()
    a8, ar, ac = qt.backward_bf16_square_double_mxfp8(x)
    fq, fs = qt.fusedQuantizeMx(x, eye, method="abs_max")
    b8, be = qt.mxfp4_transpose_mxfp8(fq, fs)
    out = qt.matmul_mxf8_bf16_nn(a8, b8, ac, be, 1.0)
    out_tn = qt.matmul_mxf8_bf16_tn(a8.T.contiguous(), b8, ac, be, 1.0)
    torch.cuda.synchronize()
    counts = dict(dispatch.launch_counts)
    for name in ("square_double_mxfp8", "mxfp4_transpose_mxfp8", "gemm_fp8_mx"):
        assert counts[name] > 0, name
    xc = x.cpu()
    a8c, _, acc = qt.backward_bf16_square_double_mxfp8(xc)
    fqc, fsc = qt.fusedQuantizeMx(xc, eye.cpu(), method="abs_max")
    b8c, bec = qt.mxfp4_transpose_mxfp8(fqc, fsc)
    assert torch.equal(a8.cpu(), a8c) and torch.equal(b8.cpu(), b8c)
    want = qt.matmul_mxf8_bf16_nn(a8c, b8c, acc, bec, 1.0)
    assert _ulps(out.cpu(), want)[1] <= 1 and torch.equal(out, out_tn)
    ref = xc.double().T @ xc.double()
    o = out.double().cpu()
    assert float((o.ravel() @ ref.ravel()) / (o.norm() * ref.norm())) > 0.99


@pytest.mark.parametrize("m", [96, 100, 4096, 4, 13])
def test_gemm_int8_rank1_backward_orders(dev, m):
    """K3 in the int8 backward's two orders, sb = 1 and alpha = 1: dgrad
    [M, N] x [K, N] and wgrad [N, M] x [K, M] with M zero-padded to 16."""
    g = torch.Generator(device=dev).manual_seed(15)
    n, k = 192, 256
    gq = torch.randint(-127, 128, (m, n), generator=g, device=dev, dtype=torch.int8)
    wi = torch.randint(-96, 97, (k, n), generator=g, device=dev, dtype=torch.int8)
    xi = torch.randint(-96, 97, (k, m), generator=g, device=dev, dtype=torch.int8)
    sg_m = torch.rand(m, generator=g, device=dev)
    sg_n = torch.rand(n, generator=g, device=dev)
    ones_k = torch.ones(k, device=dev)
    dxh = G.gemm_int8_rank1(gq, wi, sg_m, ones_k, 1.0, a_kmajor=False, b_kmajor=False)
    gqt = qt.pad_to_block(gq.T.contiguous(), [1], 16)
    xip = qt.pad_to_block(xi, [1], 16)
    dwh = G.gemm_int8_rank1(gqt, xip, sg_n, ones_k, 1.0, a_kmajor=False, b_kmajor=False)
    torch.cuda.synchronize()
    assert torch.equal(dxh, G.gemm_int8_rank1_plain(gq, wi, sg_m, ones_k, 1.0))
    assert torch.equal(dwh, G.gemm_int8_rank1_plain(gq.T, xi, sg_n, ones_k, 1.0))


def test_bf16_matmul_sums_in_fp32_on_the_card(dev):
    """The training path's bf16 GEMM (one cuBLAS call with an fp32
    output) rounds an fp32 sum once, also where the caller allows cuBLAS
    a reduced-precision split-K reduction, and leaves that setting alone.
    Positive operands: no cancellation, so the sum rounds as fp64's."""
    g = torch.Generator(device=dev).manual_seed(20)
    a = torch.rand((64, 65536), generator=g, device=dev).to(torch.bfloat16)
    b = torch.rand((65536, 48), generator=g, device=dev).to(torch.bfloat16)
    flags = torch.backends.cuda.matmul
    prev = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = True
    try:
        y = L._bf16_matmul(a, b)
        assert flags.allow_bf16_reduced_precision_reduction is True
    finally:
        flags.allow_bf16_reduced_precision_reduction = prev
    rate, ulps = _ulps(y, (a.double() @ b.double()).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and rate <= 1e-2 and ulps <= 1


def _cos(a, b):
    a, b = a.float().cpu().ravel(), b.float().cpu().ravel()
    return float(a @ b / (a.norm() * b.norm()))


@pytest.mark.parametrize("grad_mode", ["int8", "mxfp8", "bf16"])
@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_quartet_linear_cuda_matches_cpu(dev, grad_mode, method):
    """One quartet_linear step on the card launches K1 and K3 (and K8 for
    mxfp8) and agrees with the same step on the CPU plain path."""
    m, k, n = 200, 512, 384
    x = _x(dev, m, k, seed=16)
    w = _x(dev, n, k, seed=17, scale=k ** -0.5)
    gy = _x(dev, m, n, seed=18, scale=0.1)
    h = qt.hadamard_matrix(32, device=dev)
    outs = []
    for d in (dev, torch.device("cpu")):
        xd = x.detach().to(d).clone().requires_grad_()
        wd = w.detach().to(d).clone().requires_grad_()
        dispatch.reset_launch_counts()
        y = L.quartet_linear(xd, wd, h.to(d), method, grad_mode)
        y.backward(gy.to(d))
        outs.append((y.detach(), xd.grad, wd.grad, dict(dispatch.launch_counts)))
    torch.cuda.synchronize()
    (yc, dxc, dwc, counts), (y0, dx0, dw0, _) = outs
    assert counts["quantize_mx"] == 2 and counts["gemm_int8_rank1"] == (
        3 if grad_mode == "int8" else 1)
    assert counts["square_double_scaled"] == (1 if grad_mode == "mxfp8" else 0)
    for got, want in ((yc, y0), (dxc, dx0), (dwc, dw0)):
        assert bool(torch.isfinite(got).all()) and _cos(got, want) >= 0.9999


def test_quartet_mlp_trains_on_the_card(dev):
    """A few Adam steps of the QAT example's MLP on the card lower the
    loss; eval mode runs K1 and K4."""
    g = torch.Generator(device=dev).manual_seed(19)
    mlp = L.QuartetMLP(256, 512, 256, device=dev, generator=g)
    teacher = torch.randn((256, 256), generator=g, device=dev) * 0.1
    opt = torch.optim.Adam(mlp.parameters(), lr=3e-3)
    losses = []
    for _ in range(8):
        x = torch.randn((128, 256), generator=g, device=dev).to(torch.bfloat16)
        loss = ((mlp(x).float() - x.float() @ teacher.T) ** 2).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0]
    mlp.eval()
    dispatch.reset_launch_counts()
    with torch.no_grad():
        y = mlp(x)
    torch.cuda.synchronize()
    assert dispatch.launch_counts["gemm_fp4_mx"] == 2 and bool(torch.isfinite(y).all())


# ---------------------------------------------------------------------------
# the Quartet backward-operand ops: K12-K15
# ---------------------------------------------------------------------------

def _code_rate(got, want):
    return (E.unpack_codes(got) != E.unpack_codes(want)).float().mean().item()


def _bwd_input(dev, n, k, seed, special=False):
    """bf16 [..., n, k]; ``special`` puts a zero group along N in every
    column, a group of fp32-subnormal values and a NaN and an inf group
    into the last matrix."""
    x = _x(dev, n, k, seed=seed, scale=3.0).float()
    if special:
        x[32:64] = 0.0
        x[64:96, 1] = torch.linspace(-1, 1, 32, device=dev) * 2.0 ** -130
        x[96, 2] = float("nan")
        x[128, 3] = float("inf")
    return x.to(torch.bfloat16)


@pytest.mark.parametrize("shape,rot", [((256, 512), 16), ((256, 512), 32), ((96, 70), 32),
                                       ((128, 33), 128), ((2, 128, 64), 64),
                                       ((4096, 4096), 32)])
def test_backward_t_kernel(dev, shape, rot):
    x = _x(dev, *shape, seed=12, scale=4.0)
    h = qt.hadamard_matrix(rot, device=dev)
    q, s = B.backward_t_bf16(x, h, rot_size=rot)
    qw, sw = B.backward_t_bf16_plain(x, h, rot_size=rot)
    torch.cuda.synchronize()
    assert torch.equal(s, sw)
    assert _code_rate(q, qw) <= 1e-4


def test_backward_t_kernel_special_groups(dev):
    """Zero, subnormal, NaN and inf groups: bytes 0, 0, 255, 255; equal to
    the plain version on the card."""
    x = _bwd_input(dev, 256, 64, 13, special=True)
    h = qt.hadamard_matrix(32, device=dev)
    q, s = B.backward_t_bf16(x, h, rot_size=32)
    qw, sw = B.backward_t_bf16_plain(x, h, rot_size=32)
    torch.cuda.synchronize()
    assert torch.equal(s, sw) and _code_rate(q, qw) <= 1e-4
    assert (s[:, 1] == 0).all() and s[1, 2] == 0 and s[2, 3] == 255 and s[3, 4] == 255
    assert (q[:, 16:32] == 0).all() and (q[1, 32:48] != 0).any()


@pytest.mark.parametrize("m,n,rot", [(256, 512, 32), (96, 64, 32), (128, 96, 128), (4096, 4096, 32)])
@pytest.mark.parametrize("alpha", [1.0, 3.0])
@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_backward_qt_kernel(dev, m, n, rot, alpha, method):
    h32 = qt.hadamard_matrix(32, device=dev)
    xq, xs = Q.quantize_mx(_x(dev, m, n, seed=14, scale=5.0), h32, rot_size=32, method=method)
    sc = xs[:m, :n // 32]                      # a strided slice of the padded buffer
    h = qt.hadamard_matrix(rot, device=dev)
    al = torch.tensor([alpha], device=dev)
    q, s = B.backward_qt_bf16(xq, sc, h, al, rot_size=rot)
    qw, sw = B.backward_qt_bf16_plain(xq, sc, h, al, rot_size=rot)
    torch.cuda.synchronize()
    assert torch.equal(s, sw)
    assert _code_rate(q, qw) <= 1e-4


@pytest.mark.parametrize("alpha", [1.0, 3.0, 0.75])
def test_backward_qt_kernel_special_groups(dev, alpha):
    """Random codes under every scale byte (0: subnormal values; 255:
    NaN), zero rows, and a batch of two: equal to the plain version."""
    g = torch.Generator(device=dev).manual_seed(15)
    xq = torch.randint(0, 256, (2, 256, 128), generator=g, device=dev, dtype=torch.uint8)
    xs = torch.arange(2 * 256 * 8, device=dev).remainder(256).to(torch.uint8).reshape(2, 256, 8)
    xq[1, 32:64], xs[1, 32:64] = 0, 127
    h = qt.hadamard_matrix(32, device=dev)
    q, s = B.backward_qt_bf16(xq, xs, h, alpha, rot_size=32)
    qw, sw = B.backward_qt_bf16_plain(xq, xs, h, alpha, rot_size=32)
    torch.cuda.synchronize()
    assert torch.equal(s, sw)
    assert _code_rate(q, qw) <= 1e-4
    assert (s[1, :, 1] == 0).all() and (s == 255).any()


@pytest.mark.parametrize("m,n", [(256, 256), (96, 512), (4096, 4096)])
@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_mxfp4_transpose_scaled_kernel(dev, m, n, method):
    """Bitwise against the plain version and against the decode of K10."""
    h = qt.hadamard_matrix(32, device=dev)
    xq, xs = Q.quantize_mx(_x(dev, m, n, seed=16, scale=5.0), h, rot_size=32, method=method)
    sc = xs[:m, :n // 32]
    y = B.mxfp4_transpose_scaled(xq, sc)
    yw = B.mxfp4_transpose_scaled_plain(xq, sc)
    f, e = B.mxfp4_transpose_mxfp8(xq, sc)
    torch.cuda.synchronize()
    assert _same_or_nan(y, yw)
    dec = (qt.codecs.e4m3_decode_f32(f)
           * qt.codecs.e8m0_decode_f32(e).repeat_interleave(32, 1)).to(torch.bfloat16)
    assert _same_or_nan(y, dec)


def test_mxfp4_transpose_scaled_kernels_every_scale_byte(dev):
    """Every e8m0 byte (0 and 255 included) under random codes: K14 and
    K15 (on the K-major bytes of the same operand, 300 rows) bitwise
    against their plain versions."""
    g = torch.Generator(device=dev).manual_seed(17)
    m, n = 320, 512
    xq = torch.randint(0, 256, (m, n // 2), generator=g, device=dev, dtype=torch.uint8)
    sc = torch.arange(m * n // 32, device=dev).remainder(256).to(torch.uint8).reshape(m, n // 32)
    assert _same_or_nan(B.mxfp4_transpose_scaled(xq, sc), B.mxfp4_transpose_scaled_plain(xq, sc))
    qk, sk = xq[:300].T.contiguous(), sc[:300].T.contiguous()
    y = B.mxfp4_transpose_scaled_kmajor(qk, sk)
    torch.cuda.synchronize()
    assert y.shape == (n, 300)
    assert _same_or_nan(y, B.mxfp4_transpose_scaled_kmajor_plain(qk, sk))


@pytest.mark.parametrize("rows,k", [(256, 512), (300, 512), (17, 64), (4096, 4096)])
@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_mxfp4_transpose_scaled_kmajor_kernel(dev, rows, k, method):
    """K15 on the K-major quantizer output: bitwise against its plain
    version and against K14 on the row-major operand."""
    h = qt.hadamard_matrix(32, device=dev)
    x = _x(dev, rows, k, seed=18, scale=2.0)
    qk, sk = Q.quantize_mx(x, h, rot_size=32, method=method, layout="kmajor")
    y = B.mxfp4_transpose_scaled_kmajor(qk, sk)
    assert _same_or_nan(y, B.mxfp4_transpose_scaled_kmajor_plain(qk, sk))
    if rows % 32 == 0:
        xq, xs = Q.quantize_mx(x, h, rot_size=32, method=method)
        assert _same_or_nan(y, B.mxfp4_transpose_scaled(xq, xs[:rows, :k // 32]))
    torch.cuda.synchronize()


def test_backward_ops_public_api_on_the_card(dev):
    """The four public ops on CUDA tensors launch K12-K15 once each."""
    h = qt.hadamard_matrix(32, device=dev)
    x = _x(dev, 300, 256, seed=19)
    dispatch.reset_launch_counts()
    qt.backward_t_bf16(x[:288], h)
    xq, xs = qt.fusedQuantizeMx(x, h, method="abs_max")
    qt.backward_qt_bf16(xq[:288], xs, h, 3.0)
    assert qt.mxfp4_transpose_scaled(xq, xs).shape == (256, 512)
    qk, sk = qt.fusedQuantizeMx(x, h, layout="kmajor")
    assert qt.mxfp4_transpose_scaled_kmajor(qk, sk).shape == (256, 300)
    torch.cuda.synchronize()
    for name in ("backward_t_bf16", "backward_qt_bf16", "mxfp4_transpose_scaled",
                 "mxfp4_transpose_scaled_kmajor"):
        assert dispatch.launch_counts[name] == 1, name


# ---------------------------------------------------------------------------
# K16 / K17: the single-kernel quantized linear
# ---------------------------------------------------------------------------

def _fl_operands(dev, fmt, method, m, n, k, rot, seed):
    """x [m, k], the rotation, the K-major weight (K1 or K5 on the card),
    alpha 0.7 and the NV activation global scale, on the card."""
    x = _x(dev, m, k, seed=seed, scale=2.0)
    h = qt.hadamard_matrix(rot, device=dev)
    w = _x(dev, n, k, seed=seed + 1, scale=k ** -0.5)
    if fmt == "mx":
        wq = Q.quantize_mx(w, h, rot_size=rot, method=method, layout="kmajor")
    else:
        wq = Q.quantize_nv(w, h, torch.tensor(300.0, device=dev), rot_size=rot,
                           method=method, layout="kmajor")
    return x, h, wq, torch.tensor([0.7], device=dev), torch.tensor(37.5, device=dev)


def _fl_routes(fmt, method, x, h, wq, al, gs, rot):
    """(K16/K17, the composition K1 + K4 / K5 + K7, the plain version, and
    the rows whose quantized activation bytes equal the plain quantizer's)."""
    (wqt, wst), kw = wq, dict(rot_size=rot, method=method)
    if fmt == "mx":
        y = FL.fused_linear_mx(x, wqt, wst, h, al, **kw)
        xq = Q.quantize_mx(x, h, layout="kmajor", **kw)
        comp = G.gemm_fp4_mx(xq[0], wqt, xq[1], wst, al, layout="kmajor")
        plain = FL.fused_linear_mx_plain(x, wqt, wst, h, al, **kw)
        xp = Q.quantize_mx_plain(x, h, layout="kmajor", **kw)
    else:
        y = FL.fused_linear_nv(x, wqt, wst, h, gs, al, **kw)
        xq = Q.quantize_nv(x, h, gs, layout="kmajor", **kw)
        comp = G.gemm_fp4_nv(xq[0], wqt, xq[1], wst, al, layout="kmajor")
        plain = FL.fused_linear_nv_plain(x, wqt, wst, h, gs, al, **kw)
        xp = Q.quantize_nv_plain(x, h, gs, layout="kmajor", **kw)
    rows = (xq[0] == xp[0]).all(0) & (xq[1] == xp[1]).all(0)
    return y, comp, plain, rows


@pytest.mark.parametrize("m,n,k,rot", [(1, 96, 96, 32), (65, 70, 96, 16), (3, 200, 4096, 16),
                                       (65, 130, 4096, 64), (1, 1000, 12288, 128),
                                       (3, 70, 12288, 32), (4, 200, 4096, 32),
                                       (16, 130, 4096, 32), (64, 130, 4096, 16),
                                       (512, 96, 4096, 16)])
@pytest.mark.parametrize("method", ["quest", "abs_max"])
@pytest.mark.parametrize("fmt", ["mx", "nv"])
def test_fused_linear_kernels(dev, fmt, method, m, n, k, rot):
    """K16 / K17 bitwise against the composition on the card (K4's and K7's
    decode kernel at M <= 16, their prefill kernel above), and against
    the plain version in every row whose quantized activation the plain
    quantizer gives bit for bit (K1 / K5 sum the rotation in another
    order than cuBLAS: at most one such row may differ here)."""
    x, h, wq, al, gs = _fl_operands(dev, fmt, method, m, n, k, rot, seed=20)
    dispatch.reset_launch_counts()
    y, comp, plain, rows = _fl_routes(fmt, method, x, h, wq, al, gs, rot)
    torch.cuda.synchronize()
    assert tuple(y.shape) == (m, n) and y.dtype == torch.bfloat16
    assert _same_or_nan(y, comp)
    gemm = f"gemm_fp4_{fmt}_" + ("decode" if m <= G.DECODE_M else "prefill")
    assert dispatch.launch_counts[gemm] == dispatch.launch_counts[f"fused_linear_{fmt}"] == 1
    assert int((~rows).sum()) <= 1
    assert _same_or_nan(y[rows], plain[rows])


def test_fused_linear_kernels_nan_and_zero_rows(dev):
    """A NaN row and a zero row: bitwise the composition and the plain
    version in both formats and methods."""
    for fmt in ("mx", "nv"):
        for method in ("quest", "abs_max"):
            x, h, wq, al, gs = _fl_operands(dev, fmt, method, 9, 96, 256, 32, seed=21)
            x[2], x[5] = float("nan"), 0.0
            y, comp, plain, rows = _fl_routes(fmt, method, x, h, wq, al, gs, 32)
            torch.cuda.synchronize()
            assert _same_or_nan(y, comp) and _same_or_nan(y[rows], plain[rows])
            assert bool((y[5] == 0).all()) and bool(rows[5])


def test_fused_linear_kernels_refuse_what_they_cannot_take(dev):
    """A CUDA call the kernel cannot take raises, launches nothing and does
    not fall back to the plain version."""
    x, h, (wqt, wst), al, gs = _fl_operands(dev, "mx", "quest", 8, 64, 256, 32, seed=22)
    dispatch.reset_launch_counts()
    bad = [lambda: FL.fused_linear_mx(x.T.contiguous().T, wqt, wst, h, al, rot_size=32,
                                      method="quest"),               # x not contiguous
           lambda: FL.fused_linear_mx(x[:, :128].contiguous(), wqt, wst, h, al, rot_size=32,
                                      method="quest"),               # K differs
           lambda: FL.fused_linear_mx(x.float(), wqt, wst, h, al, rot_size=32,
                                      method="quest"),               # not bf16
           lambda: FL.fused_linear_mx(x, wqt, wst[:4], h, al, rot_size=32,
                                      method="quest"),               # scales [K/32, N]
           lambda: FL.fused_linear_nv(x, wqt, wst, h, gs, al, rot_size=32,
                                      method="abs_max"),             # MX scales to K17
           lambda: FL.fused_linear_mx(x, wqt, wst, h, al, rot_size=16, method="quest")]
    for fn in bad:
        with pytest.raises((TypeError, ValueError)):
            fn()
    assert dispatch.launch_counts["fused_linear_mx"] == dispatch.launch_counts["fused_linear_nv"] == 0


def test_fused_linear_switch_moves_the_counters(dev, monkeypatch):
    """The public ops on the card: unset the composition's kernels launch,
    under QUTLASS_TPU_FUSED_LINEAR=1 only K16 / K17, with the same bits; a
    QuartetLinear in eval mode follows the switch."""
    out = {}
    for switch in ("", "1"):
        monkeypatch.setenv("QUTLASS_TPU_FUSED_LINEAR", switch)
        x, h, (wqt, wst), _, _ = _fl_operands(dev, "mx", "abs_max", 4, 96, 512, 32, seed=23)
        _, _, (nqt, nst), al, gs = _fl_operands(dev, "nv", "abs_max", 4, 96, 512, 32, seed=23)
        lin = L.QuartetLinear(512, 96, rot_size=32, device=dev,
                              generator=torch.Generator(device=dev).manual_seed(0)).eval()
        dispatch.reset_launch_counts()
        with torch.no_grad():
            out[switch] = (qt.fused_linear_mxf4(x.reshape(2, 2, 512), wqt, wst, h, al,
                                                method="abs_max"),
                           qt.fused_linear_nvf4(x, nqt, nst, h, gs, al), lin(x))
        torch.cuda.synchronize()
        c = dispatch.launch_counts
        single = switch == "1"
        assert c["fused_linear_mx"] == (2 if single else 0)
        assert c["fused_linear_nv"] == (1 if single else 0)
        assert c["gemm_fp4_mx"] == (0 if single else 2) and c["gemm_fp4_nv"] == (0 if single else 1)
        assert c["quantize_mx"] == (1 if single else 3)            # the layer's weight, and x
        assert c["quantize_nv"] == (0 if single else 1)
    assert out[""][0].shape == (2, 2, 96)
    for a, b in zip(out[""], out["1"]):
        assert _same_or_nan(a, b)
