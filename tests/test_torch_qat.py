"""The port's Quartet QAT training path (``quartet_linear``,
``QuartetLinear``, the QAT example's MLP) on CPU tensors against the JAX
package's ``quartet_linear`` under ``jax.vjp``, fed the same numpy inputs.

Tolerances: the forward bitwise (K1's plain version, the plane-major int8
encode and K3's plain version equal the JAX package's ops); y, dx and dw
within cosine 0.9999 in every grad mode and method (the unrotation's
fp32 sums run in another order than XLA's); the int8 contractions, their
scales and the clip-mask unpack bitwise given the same residuals and dY;
the example's first loss within 1e-3 relative of JAX's.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import qutlass_tpu as q
import qutlass_tpu_torch as qt
from qutlass_tpu.nn import linear as JL
from qutlass_tpu_torch import models as TM
from qutlass_tpu_torch.nn import linear as TL
from torch_helpers import cosine, hadamard_np, randn_bf16, to_np, to_torch


def _u16(t) -> np.ndarray:
    return (to_np(t) if isinstance(t, torch.Tensor) else np.asarray(t)).view(np.uint16)


def _inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = randn_bf16(rng, m, k, scale=1.0)
    w = randn_bf16(rng, n, k, scale=k ** -0.5)
    gy = randn_bf16(rng, m, n, scale=0.1)
    return x, w, gy


def _jax_step(x, w, gy, h, method, grad_mode):
    f = lambda xx, ww: JL.quartet_linear(xx, ww, jnp.asarray(h), method, grad_mode)
    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(gy))
    return np.asarray(y), np.asarray(dx), np.asarray(dw)


def _torch_step(x, w, gy, h, method, grad_mode):
    tx, tw = to_torch(x).requires_grad_(), to_torch(w).requires_grad_()
    th = to_torch(h).requires_grad_()
    y = TL.quartet_linear(tx, tw, th, method, grad_mode)
    y.backward(to_torch(gy))
    return y.detach(), tx.grad, tw.grad, th.grad


@pytest.mark.parametrize("m,k,n,rot", [(96, 256, 128, 32), (50, 512, 96, 16),
                                       (128, 384, 160, 64)])
@pytest.mark.parametrize("grad_mode", ["int8", "mxfp8", "bf16"])
@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_quartet_linear_matches_jax(m, k, n, rot, grad_mode, method):
    x, w, gy = _inputs(m, k, n)
    h = hadamard_np(rot)
    jy, jdx, jdw = _jax_step(x, w, gy, h, method, grad_mode)
    y, dx, dw, dh = _torch_step(x, w, gy, h, method, grad_mode)
    np.testing.assert_array_equal(_u16(y), jy.view(np.uint16))
    for got, want in ((dx, jdx), (dw, jdw)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert cosine(to_np(got).astype(np.float32), want.astype(np.float32)) >= 0.9999
    assert torch.equal(dh, torch.zeros_like(dh))


def _residuals(m, k, n, method, seed=1):
    x, w, gy = _inputs(m, k, n, seed)
    h = hadamard_np(32)
    y, res = JL._quartet_fwd_impl(jnp.asarray(x), jnp.asarray(w), jnp.asarray(h), method)
    tres = tuple(None if r is None else to_torch(np.asarray(r)) for r in res)
    return res, tres, gy, h, y


@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_forward_and_residuals_bitwise(method):
    m, k, n = 64, 256, 96
    x, w, _ = _inputs(m, k, n, 1)
    h = hadamard_np(32)
    jy, jres = JL._quartet_fwd_impl(jnp.asarray(x), jnp.asarray(w), jnp.asarray(h), method)
    y, res = TL.quartet_forward(to_torch(x), to_torch(w), to_torch(h), method)
    np.testing.assert_array_equal(_u16(y), np.asarray(jy).view(np.uint16))
    for got, want in zip(res, jres):
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m", [64, 50])
@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_int8_contractions_bitwise(m, method):
    """The int8 grad mode's two contractions (K3's plain version, sb = 1,
    M zero-padded to 16 for the wgrad) and their row/column scales equal
    the JAX package's int32 dots times the same scales."""
    k, n = 256, 96
    res, tres, gy, _, _ = _residuals(m, k, n, method)
    xi, sx, wi, sw, _ = res
    al = 1.0 if method == "quest" else 1.0 / 9.0

    @jax.jit
    def jax_parts(gy, xi, sx, wi, sw):
        gy32 = gy.astype(jnp.float32)
        gq_d, sg_d = JL._int8_quantize_rows(gy32 * (sw[None, :] * al), axis=1)
        dxh = jax.lax.dot_general(gq_d, wi, (((1,), (1,)), ((), ())),
                                  preferred_element_type=jnp.int32
                                  ).astype(jnp.float32) * sg_d[:, None]
        gq_w, sg_w = JL._int8_quantize_rows(gy32 * (sx[:, None] * al), axis=0)
        dwh = jax.lax.dot_general(gq_w, xi, (((0,), (1,)), ((), ())),
                                  preferred_element_type=jnp.int32
                                  ).astype(jnp.float32) * sg_w[:, None]
        return sg_d, sg_w, dxh.astype(jnp.bfloat16), dwh.astype(jnp.bfloat16)

    sg_d, sg_w, jdxh, jdwh = jax_parts(jnp.asarray(gy), xi, sx, wi, sw)
    dxh, dwh = TL.quartet_grads_planes(tres, to_torch(gy), method, "int8")
    np.testing.assert_array_equal(_u16(dxh), np.asarray(jdxh).view(np.uint16))
    np.testing.assert_array_equal(_u16(dwh), np.asarray(jdwh).view(np.uint16))
    g32 = to_torch(gy).float()
    _, tsg_d = TL._int8_quantize_rows(g32 * (tres[3][None, :] * al), 1)
    _, tsg_w = TL._int8_quantize_rows((g32 * (tres[1][:, None] * al)).T.contiguous(), 1)
    np.testing.assert_array_equal(tsg_d.numpy(), np.asarray(sg_d))
    np.testing.assert_array_equal(tsg_w.numpy(), np.asarray(sg_w))


@pytest.mark.parametrize("axis", [0, 1])
def test_int8_quantize_rows_bitwise(axis):
    v = (np.random.default_rng(2).standard_normal((70, 96)) * 0.01).astype(np.float32)
    v[3] = 0.0
    jq, js = jax.jit(lambda a: JL._int8_quantize_rows(a, axis))(jnp.asarray(v))
    tq, ts = TL._int8_quantize_rows(torch.tensor(v), axis)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("grad_mode", ["mxfp8", "bf16"])
@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_bf16_contractions_given_residuals(grad_mode, method):
    """The mxfp8 and bf16 modes' contractions (K8's plain version, then
    bf16 products with fp32 sums) against the JAX package's dots on the
    same residuals: cosine 0.9999 (sum order), nearly all bits equal."""
    m, k, n = 96, 256, 128
    res, tres, gy, _, _ = _residuals(m, k, n, method, seed=3)
    xi, sx, wi, sw, _ = res
    al = 1.0 if method == "quest" else 1.0 / 9.0
    g = (q.backward_square_double_scaled(jnp.asarray(gy))[:m].astype(jnp.float32)
         if grad_mode == "mxfp8" else jnp.asarray(gy).astype(jnp.float32))
    gyw = (g * (sw[None, :] * al)).astype(jnp.bfloat16)
    gyx = (g * (sx[:m, None] * al)).astype(jnp.bfloat16)
    jdxh = jax.lax.dot_general(gyw, wi.astype(jnp.bfloat16), (((1,), (1,)), ((), ())),
                               preferred_element_type=jnp.float32).astype(jnp.bfloat16)
    jdwh = jax.lax.dot_general(gyx, xi.astype(jnp.bfloat16), (((0,), (1,)), ((), ())),
                               preferred_element_type=jnp.float32).astype(jnp.bfloat16)
    dxh, dwh = TL.quartet_grads_planes(tres, to_torch(gy), method, grad_mode)
    for got, want in ((dxh, jdxh), (dwh, jdwh)):
        w = np.asarray(want)
        assert cosine(to_np(got).astype(np.float32), w.astype(np.float32)) >= 0.9999
        assert (_u16(got) != w.view(np.uint16)).mean() <= 1e-2


@pytest.mark.parametrize("k", [256, 96])
def test_mask_unpack_bitwise(k):
    rng = np.random.default_rng(4)
    mask_t = rng.integers(0, 256, (k // 8, 40), dtype=np.uint8)
    np.testing.assert_array_equal(
        _u16(TL._unpack_mask_planes(to_torch(mask_t), k)),
        np.asarray(JL._unpack_mask_planes(jnp.asarray(mask_t), k)).view(np.uint16))
    np.testing.assert_array_equal(
        TL._unpack_mask_bits(to_torch(mask_t.T.copy()), k).numpy(),
        np.asarray(JL._unpack_mask_bits(jnp.asarray(mask_t.T.copy()), k)))


@pytest.mark.parametrize("k,rot", [(256, 32), (96, 32), (128, 128)])
def test_unrotate_planes(k, rot):
    """The plane-major unrotation against the JAX package's (fp32 sums:
    close, not bitwise) and against de-interleaving then unrotating."""
    rng = np.random.default_rng(5)
    v = randn_bf16(rng, 24, k, scale=1.0)
    h = hadamard_np(rot)
    got = TL._unrotate_planes(to_torch(v), to_torch(h))
    want = np.asarray(JL._unrotate_planes(jnp.asarray(v), jnp.asarray(h)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    nat = np.stack([v[:, :k // 2], v[:, k // 2:]], -1).reshape(24, k)
    np.testing.assert_allclose(got.numpy(), TL._unrotate(to_torch(nat), to_torch(h)).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_quartet_linear_validation():
    x = torch.zeros(32, 64, dtype=torch.bfloat16)
    h = qt.hadamard_matrix(32, device="cpu")
    with pytest.raises(ValueError):
        TL.quartet_linear(x, x, h, "quest", "fp16")
    with pytest.raises(ValueError):
        TL.quartet_linear(x, x, h, "rtn")


@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_reference_flow_and_weight_cache_bitwise(method):
    x, w, _ = _inputs(64, 256, 96, 6)
    h = hadamard_np(32)
    want = JL.quartet_linear_reference_flow(jnp.asarray(x), jnp.asarray(w), jnp.asarray(h),
                                            method)
    got = TL.quartet_linear_reference_flow(to_torch(x), to_torch(w), to_torch(h), method)
    np.testing.assert_array_equal(_u16(got), np.asarray(want).view(np.uint16))
    jq, js = JL.quantize_weights_mx(jnp.asarray(w), jnp.asarray(h), method)
    tq, ts = TL.quantize_weights_mx(to_torch(w), to_torch(h), method)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_quartet_linear_module_modes(method):
    """Training mode is quartet_linear; eval mode is the JAX package's
    fused_linear_mxf4 composition (K1 K-major, then K4), bitwise."""
    x, w, gy = _inputs(40, 256, 96, 7)
    lin = TL.QuartetLinear(256, 96, rot_size=32, method=method, grad_mode="bf16",
                           device="cpu")
    with torch.no_grad():
        lin.weight.copy_(to_torch(w))
    xt = to_torch(x).reshape(2, 20, 256)
    y = lin(xt)
    assert y.shape == (2, 20, 96) and y.dtype == torch.bfloat16
    y.backward(to_torch(gy).reshape(2, 20, 96))
    jy, _, jdw = _jax_step(x, w, gy, hadamard_np(32), method, "bf16")
    np.testing.assert_array_equal(_u16(y.reshape(40, 96)), jy.view(np.uint16))
    assert cosine(to_np(lin.weight.grad).astype(np.float32), jdw.astype(np.float32)) >= 0.9999
    lin.eval()
    with torch.no_grad():
        ye = lin(to_torch(x))
    h = jnp.asarray(hadamard_np(32))
    wqt, wst = q.fusedQuantizeMx(jnp.asarray(w), h, method=method, layout="kmajor")
    want = q.fused_linear_mxf4(jnp.asarray(x), wqt, wst, h, method=method)
    np.testing.assert_array_equal(_u16(ye), np.asarray(want).view(np.uint16))


def test_quartet_linear_module_init():
    g = torch.Generator().manual_seed(0)
    lin = TL.QuartetLinear(512, 256, device="cpu", generator=g)
    assert lin.weight.dtype == torch.bfloat16 and lin.weight.requires_grad
    assert abs(lin.weight.float().std().item() - 512 ** -0.5) < 2e-3
    assert lin.h.shape == (32, 32) and lin.training


def _example_params():
    """examples/qat_training.py's weights and teacher (JAX PRNGKey(0))."""
    key = jax.random.PRNGKey(0)
    k1, k2, k3 = jax.random.split(key, 3)
    params = {"w1": (jax.random.normal(k1, (512, 256)) * 0.05).astype(jnp.bfloat16),
              "w2": (jax.random.normal(k2, (256, 512)) * 0.05).astype(jnp.bfloat16)}
    teacher = jax.random.normal(k3, (256, 256)) * 0.1
    return jax.tree.map(np.asarray, params), np.asarray(teacher)


@pytest.mark.parametrize("grad_mode", ["int8", "mxfp8", "bf16"])
def test_qat_example_training_loop(grad_mode):
    """The QAT example at its own widths (256 -> 512 -> 256, batch 128)
    from the JAX package's weights: the first loss equals JAX's within
    1e-3 relative, and 40 Adam steps bring the loss below half."""
    params, teacher = _example_params()
    h = jnp.asarray(hadamard_np(32))
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((128, 256)).astype(ml_dtypes.bfloat16) for _ in range(40)]

    def jax_loss(p, x):
        y = JL.quartet_linear(x, p["w1"], h, "quest", grad_mode)
        y = jax.nn.silu(y.astype(jnp.float32)).astype(jnp.bfloat16)
        y = JL.quartet_linear(y, p["w2"], h, "quest", grad_mode)
        return jnp.mean((y.astype(jnp.float32) - x.astype(jnp.float32) @ teacher.T) ** 2)

    first_jax = float(jax_loss(jax.tree.map(jnp.asarray, params), jnp.asarray(xs[0])))
    mlp = TM.quartet_mlp_from_numpy(params, grad_mode=grad_mode, device="cpu")
    opt = torch.optim.Adam(mlp.parameters(), lr=3e-3)
    tt = torch.tensor(teacher)
    losses = []
    for x in xs:
        xt = to_torch(x)
        loss = ((mlp(xt).float() - xt.float() @ tt.T) ** 2).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert abs(losses[0] - first_jax) <= 1e-3 * first_jax, (losses[0], first_jax)
    assert all(np.isfinite(losses)) and losses[-1] < 0.5 * losses[0], losses


def test_quartet_mlp_from_numpy_keeps_weights():
    params, _ = _example_params()
    mlp = TM.quartet_mlp_from_numpy(params, method="abs_max", device="cpu")
    np.testing.assert_array_equal(_u16(mlp.fc1.weight.detach()), params["w1"].view(np.uint16))
    np.testing.assert_array_equal(_u16(mlp.fc2.weight.detach()), params["w2"].view(np.uint16))
    assert mlp.fc1.method == "abs_max" and mlp.fc2.weight.shape == (256, 512)


def test_bf16_matmul_disables_reduced_precision_reduction():
    """The training path's bf16 GEMMs sum in fp32 and round once (as the
    JAX package's bf16 dot into fp32) even where the caller allows a
    reduced-precision reduction, and leave the caller's setting alone."""
    flags = torch.backends.cuda.matmul
    prev = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = True
    try:
        # 1 + 4095 * 2^-9: a bf16 running sum stalls at 1 (half its ulp is 2^-8)
        a = torch.full((2, 4096), 2.0 ** -9, dtype=torch.bfloat16)
        a[:, 0] = 1.0
        y = TL._bf16_matmul(a, torch.ones(4096, 3, dtype=torch.bfloat16))
        want = torch.tensor(1 + 4095 * 2.0 ** -9, dtype=torch.float64).to(torch.bfloat16)
        assert y.dtype == torch.bfloat16 and bool((y == want).all())
        assert flags.allow_bf16_reduced_precision_reduction is True
    finally:
        flags.allow_bf16_reduced_precision_reduction = prev
