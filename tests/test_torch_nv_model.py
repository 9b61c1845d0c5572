"""The NVFP4 serving slice as a whole: the port's model and serving loop
on NV weights against the JAX package, with the JAX parameters (and the
JAX-quantized NV weights) carried across by ``params_from_numpy``.

Tolerances: quantized logits cosine > 0.95 to JAX's (the MX model
test's bar, tests/test_torch_model.py; W4A4
turns 1-ulp differences between the two frameworks' fp32 reductions into
e2m1 code flips, and the JAX package's own NV paths differ from each
other at cosine 0.964, tests/test_models.py); generate and calibration
equalities are bitwise.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from qutlass_tpu.models import calibrate_nv_gsx as j_calibrate
from qutlass_tpu.models import decode_step as j_decode_step
from qutlass_tpu.models import init_params as j_init_params
from qutlass_tpu.models import prefill as j_prefill
from qutlass_tpu.models import quantize_model_weights as j_quantize
from qutlass_tpu.models import tiny_config as j_tiny_config
from qutlass_tpu_torch import models as M
from qutlass_tpu_torch.models.transformer import PROJECTIONS
from torch_helpers import cosine, hadamard_np, to_torch

MAX_LEN = 16
STORAGES = ["int8", "fp4"]
NV_LEAVES = {"int8": ["gs", "nvi8", "nvsb"], "fp4": ["gs", "wqt", "wst"]}


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


@pytest.fixture(scope="module")
def setup():
    jcfg = j_tiny_config()
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    h = hadamard_np(32)
    jq = {wf: j_quantize(jcfg, jparams, jnp.asarray(h), fmt="nv", weight_format=wf)
          for wf in STORAGES}
    return dict(jcfg=jcfg, cfg=M.tiny_config(), jq=jq, h=h,
                params=M.params_from_numpy(_np_tree(jparams), device="cpu"),
                qparams={wf: M.params_from_numpy(_np_tree(jq[wf]), device="cpu")
                         for wf in STORAGES})


def _tokens(seed, b, t, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(np.int32)


@pytest.mark.parametrize("wf", STORAGES)
def test_params_from_numpy_carries_the_nv_leaves(setup, wf):
    """The generic converter carries nvi8/nvsb/gs (or wqt/wst/gs) and gsx
    leaves with their dtypes and bits."""
    jw = dict(setup["jq"][wf]["layers"][1]["up_proj"], gsx=jnp.float32(3.25))
    tw = M.params_from_numpy(_np_tree(jw), device="cpu")
    assert sorted(tw) == sorted(NV_LEAVES[wf] + ["gsx"])
    for name, t in tw.items():
        want = np.asarray(jw[name])
        assert t.numpy().dtype == want.dtype and t.shape == want.shape
        np.testing.assert_array_equal(t.numpy().reshape(-1).view(np.uint8),
                                      want.reshape(-1).view(np.uint8))


@pytest.mark.parametrize("wf", STORAGES)
def test_nv_quantize_model_weights_matches_jax(setup, wf):
    """The port's NV weight prep from the same bf16 weights: JAX's leaves,
    global scales within an ulp, stored bytes at a mismatch rate <= 1e-4."""
    mine = M.quantize_model_weights(setup["cfg"], setup["params"],
                                    to_torch(setup["h"]), fmt="nv", weight_format=wf)
    for jl, tl in zip(setup["jq"][wf]["layers"], mine["layers"]):
        for name in PROJECTIONS:
            jw, tw = jl[name], tl[name]
            assert sorted(tw) == NV_LEAVES[wf]
            np.testing.assert_allclose(float(tw["gs"]), float(jw["gs"]), rtol=2 ** -23)
            for leaf in NV_LEAVES[wf][1:]:
                assert (tw[leaf].numpy() != np.asarray(jw[leaf])).mean() <= 1e-4


def _jax_replay(s, params, toks, t0):
    h = jnp.asarray(s["h"])
    logits, cache = j_prefill(s["jcfg"], params, jnp.asarray(toks[:, :t0]), h,
                              max_len=MAX_LEN, quantized=True)
    out = [np.asarray(logits)]
    for p in range(t0, toks.shape[1]):
        logits, cache = j_decode_step(s["jcfg"], params, cache, jnp.asarray(toks[:, p]),
                                      jnp.int32(p), h, quantized=True)
        out.append(np.asarray(logits))
    return out


def _port_replay(s, params, toks, t0):
    h = to_torch(s["h"])
    tt = torch.from_numpy(toks).long()
    logits, cache = M.prefill(s["cfg"], params, tt[:, :t0], h, max_len=MAX_LEN,
                              quantized=True)
    out = [logits.numpy()]
    for p in range(t0, toks.shape[1]):
        logits, cache = M.decode_step(s["cfg"], params, cache, tt[:, p], p, h,
                                      quantized=True)
        out.append(logits.numpy())
    return out


@pytest.mark.parametrize("wf", STORAGES)
def test_nv_prefill_and_decode_cosine_to_jax(setup, wf):
    """Prefill and teacher-forced decode logits on JAX's NV weights:
    cosine > 0.95 to JAX's at every step."""
    toks = _tokens(4, 2, 12)
    want = _jax_replay(setup, setup["jq"][wf], toks, 8)
    got = _port_replay(setup, setup["qparams"][wf], toks, 8)
    for step, (w, g) in enumerate(zip(want, got)):
        assert np.isfinite(g).all()
        assert cosine(g, w) > 0.95, (step, cosine(g, w))


@pytest.mark.parametrize("wf", STORAGES)
def test_nv_generate_equals_manual_replay(setup, wf):
    """generate on NV weights (ragged prompts) equals prefill + one
    decode_step per token, bit for bit: the serving loop runs unchanged."""
    cfg, params, h = setup["cfg"], setup["qparams"][wf], to_torch(setup["h"])
    prompt = torch.from_numpy(_tokens(5, 2, 6)).long()
    lengths = torch.tensor([6, 4])
    out = M.generate(cfg, params, prompt, h, steps=4, max_len=MAX_LEN,
                     lengths=lengths, quantized=True)
    logits, cache = M.prefill(cfg, params, prompt, h, max_len=MAX_LEN,
                              quantized=True, lengths=lengths)
    tok, pos, manual = logits.argmax(-1), lengths.clone(), []
    for _ in range(4):
        manual.append(tok)
        logits, cache = M.decode_step(cfg, params, cache, tok, pos, h, quantized=True)
        tok, pos = logits.argmax(-1), pos + 1
    np.testing.assert_array_equal(out.numpy(), torch.stack(manual, 1).numpy())


@pytest.mark.parametrize("wf", STORAGES)
def test_nv_calibrated_gsx_equals_the_exact_path(setup, wf):
    """calibrate_nv_gsx with margin 1 on its own batch stores a gsx leaf
    in every NV linear, and the forward with those static scales equals
    the exact per-call path bit for bit; the calibrated scales are
    JAX's (on JAX's weights) within 1e-5 relative."""
    cfg, h = setup["cfg"], to_torch(setup["h"])
    params = M.params_from_numpy(_np_tree(setup["jq"][wf]), device="cpu")
    toks = torch.from_numpy(_tokens(1, 2, 16)).long()
    exact = M.forward(cfg, params, toks, h, quantized=True)
    M.calibrate_nv_gsx(cfg, params, toks, h)
    assert sum("gsx" in layer[p] for layer in params["layers"]
               for p in PROJECTIONS) == 7 * cfg.num_layers
    static = M.forward(cfg, params, toks, h, quantized=True)
    assert torch.equal(exact, static)
    jq = jax.tree.map(lambda a: a, setup["jq"][wf])
    j_calibrate(setup["jcfg"], jq, jnp.asarray(toks.numpy()), jnp.asarray(setup["h"]))
    for jl, tl in zip(jq["layers"], params["layers"]):
        for p in PROJECTIONS:
            np.testing.assert_allclose(float(tl[p]["gsx"]), float(jl[p]["gsx"]), rtol=1e-5)
