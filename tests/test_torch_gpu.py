"""Each Hopper kernel against its plain PyTorch version on the card, at
small shapes.  Marked ``gpu``: they skip without a CUDA device and run on
the H100 through ``chip_smoke.py`` (which runs this file with
``--noconftest``, since the repo's conftest imports JAX).  This file
imports no JAX.

Tolerances: MX quantizer scale bytes exact and codes within a 1e-4
mismatch rate (the kernels sum the rotation in another order than
cuBLAS); NV quantizer scale bytes and codes within a 1e-4 mismatch rate
(an e4m3 byte, unlike a power-of-two floor, moves with an ulp of its
input), K6's a' and sigma equal wherever a row's bytes agree; GEMMs
bitwise.
"""
import pytest
import torch

import qutlass_tpu_torch as qt
from qutlass_tpu_torch import models as M
from qutlass_tpu_torch.kernels import gemm as G
from qutlass_tpu_torch.kernels import quantize as Q
from qutlass_tpu_torch.ops import dispatch
from qutlass_tpu_torch.ops import emulation as E
from qutlass_tpu_torch.ops import int8path as I8

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


@pytest.mark.parametrize("layout", ["rowmajor", "kmajor", "kmajor_codes"])
@pytest.mark.parametrize("rot,shape", [(16, (70, 640)), (32, (70, 640)),
                                       (64, (70, 640)), (128, (70, 640)),
                                       (16, (33, 160)), (32, (1, 96))])
@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_quantize_mx_kernel(dev, method, rot, shape, layout):
    x, h = _x(dev, *shape, scale=25.0), qt.hadamard_matrix(rot, device=dev)
    mask = method == "quest"
    got = Q.quantize_mx(x, h, rot_size=rot, method=method, return_mask=mask,
                        layout=layout)
    want = Q.quantize_mx_plain(x, h, rot_size=rot, method=method,
                               return_mask=mask, layout=layout)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    assert (_codes(got[0], layout) != _codes(want[0], layout)).float().mean() <= 1e-4
    if mask:
        assert (got[2] != want[2]).float().mean() <= 1e-4


@pytest.mark.parametrize("rot,shape", [(16, (13, 1536)), (32, (13, 1536)),
                                       (128, (13, 1536)), (32, (9, 160))])
@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_quantize_mx_int8_kernel(dev, method, rot, shape):
    x, h = _x(dev, *shape, seed=1), qt.hadamard_matrix(rot, device=dev)
    ga, gs, gb = Q.quantize_mx_int8(x, h, rot_size=rot, method=method)
    wa, ws, wb = Q.quantize_mx_int8_plain(x, h, rot_size=rot, method=method)
    torch.cuda.synchronize()
    assert torch.equal(gb, wb) and torch.equal(gs, ws)
    assert (ga != wa).float().mean() <= 1e-4


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
                                       (16, (33, 48)), (32, (1, 96))])
@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_quantize_nv_kernel(dev, method, rot, shape, layout):
    x, h = _x(dev, *shape, scale=25.0), qt.hadamard_matrix(rot, device=dev)
    gs = torch.tensor(2.5, device=dev)
    got = Q.quantize_nv(x, h, gs, rot_size=rot, method=method, layout=layout)
    want = Q.quantize_nv_plain(x, h, gs, rot_size=rot, method=method, layout=layout)
    torch.cuda.synchronize()
    assert got[1].shape == want[1].shape and got[0].shape == want[0].shape
    assert (got[1] != want[1]).float().mean() <= 1e-4
    assert (_codes(got[0], layout) != _codes(want[0], layout)).float().mean() <= 1e-4


@pytest.mark.parametrize("rot,shape", [(16, (13, 1536)), (32, (4, 4096)),
                                       (128, (13, 1536)), (16, (9, 48))])
@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_quantize_nv_int8_kernel(dev, method, rot, shape):
    x, h = _x(dev, *shape, seed=1), qt.hadamard_matrix(rot, device=dev)
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
