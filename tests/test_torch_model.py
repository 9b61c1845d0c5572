"""The slice as a whole: the port's model and serving loop against the JAX
package, with the JAX parameters carried across by ``params_from_numpy``.

Tolerances (those of tests/test_serving.py): unquantized logits within
rtol = atol = 5e-2; quantized logits cosine > 0.95, because W4A4 turns
1-ulp differences between the two frameworks' fp32 reductions into e2m1
code flips (docs/NUMERICS.md), so bitwise equality cannot hold.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from qutlass_tpu.models import decode_step as j_decode_step
from qutlass_tpu.models import init_params as j_init_params
from qutlass_tpu.models import prefill as j_prefill
from qutlass_tpu.models import quantize_model_weights as j_quantize
from qutlass_tpu.models import tiny_config as j_tiny_config
from qutlass_tpu_torch import models as M
from qutlass_tpu_torch.nn import QuantizedLinear, mx_linear
from torch_helpers import cosine, hadamard_np, to_np, to_torch

TOL = 5e-2
MAX_LEN = 16


@pytest.fixture(scope="module")
def setup():
    jcfg = j_tiny_config()
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    h = hadamard_np(32)
    jq = j_quantize(jcfg, jparams, jnp.asarray(h))
    to_np_tree = lambda t: jax.tree.map(np.asarray, t)
    return dict(jcfg=jcfg, cfg=M.tiny_config(), jparams=jparams, jq=jq, h=h,
                params=M.params_from_numpy(to_np_tree(jparams), device="cpu"),
                qparams=M.params_from_numpy(to_np_tree(jq), device="cpu"))


def _tokens(seed, b, t, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(np.int32)


def _jax_replay(s, params, toks, t0, quantized):
    """JAX prefill of toks[:, :t0], then teacher-forced decode of the rest:
    the logits after each position t0-1 .. T-1."""
    h = jnp.asarray(s["h"])
    logits, cache = j_prefill(s["jcfg"], params, jnp.asarray(toks[:, :t0]), h,
                              max_len=MAX_LEN, quantized=quantized)
    out = [np.asarray(logits)]
    for p in range(t0, toks.shape[1]):
        logits, cache = j_decode_step(s["jcfg"], params, cache,
                                      jnp.asarray(toks[:, p]), jnp.int32(p), h,
                                      quantized=quantized)
        out.append(np.asarray(logits))
    return out


def _port_replay(s, params, toks, t0, quantized):
    h = to_torch(s["h"])
    tt = torch.from_numpy(toks).long()
    logits, cache = M.prefill(s["cfg"], params, tt[:, :t0], h, max_len=MAX_LEN,
                              quantized=quantized)
    out = [logits.numpy()]
    for p in range(t0, toks.shape[1]):
        logits, cache = M.decode_step(s["cfg"], params, cache, tt[:, p], p, h,
                                      quantized=quantized)
        out.append(logits.numpy())
    return out


def test_unquantized_prefill_and_decode_match_jax(setup):
    toks = _tokens(1, 2, 12)
    want = _jax_replay(setup, setup["jparams"], toks, 8, False)
    got = _port_replay(setup, setup["params"], toks, 8, False)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_unquantized_forward_matches_jax(setup):
    from qutlass_tpu.models import forward as j_forward
    toks = _tokens(2, 2, 8)
    want = np.asarray(j_forward(setup["jcfg"], setup["jparams"], jnp.asarray(toks)))
    got = M.forward(setup["cfg"], setup["params"], torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_unquantized_greedy_generate_matches_jax(setup):
    """Greedy tokens equal JAX's over 4 steps.  Where JAX's top-2 logit gap
    at a step is below the logit tolerance the step is a near-tie that
    either framework may break: the comparison stops there."""
    steps, t0 = 4, 8
    prompt = _tokens(3, 2, t0)
    got = M.generate(setup["cfg"], setup["params"], torch.from_numpy(prompt).long(),
                     to_torch(setup["h"]), steps=steps, max_len=MAX_LEN).numpy()
    # JAX greedy replay: feed back its own argmax
    h = jnp.asarray(setup["h"])
    logits, cache = j_prefill(setup["jcfg"], setup["jparams"], jnp.asarray(prompt),
                              h, max_len=MAX_LEN)
    live = np.ones(2, bool)
    compared = 0
    for i in range(steps):
        lg = np.asarray(logits)
        top2 = np.sort(lg, axis=-1)[:, -2:]
        live &= (top2[:, 1] - top2[:, 0]) >= TOL
        tok = lg.argmax(-1).astype(np.int32)
        np.testing.assert_array_equal(got[live, i], tok[live])
        compared += int(live.sum())
        logits, cache = j_decode_step(setup["jcfg"], setup["jparams"], cache,
                                      jnp.asarray(tok), jnp.int32(t0 + i), h)
    assert compared >= steps        # at least half the tokens were decisive


def test_quantized_prefill_and_decode_cosine_to_jax(setup):
    toks = _tokens(4, 2, 12)
    want = _jax_replay(setup, setup["jq"], toks, 8, True)
    got = _port_replay(setup, setup["qparams"], toks, 8, True)
    for step, (w, g) in enumerate(zip(want, got)):
        assert np.isfinite(g).all()
        assert cosine(g, w) > 0.95, (step, cosine(g, w))


def test_quantize_model_weights_matches_jax(setup):
    port_q = M.quantize_model_weights(setup["cfg"], setup["params"],
                                      to_torch(setup["h"]))
    for jl, tl in zip(setup["jq"]["layers"], port_q["layers"]):
        for name in M.transformer.PROJECTIONS:
            jw, tw = jl[name], tl[name]
            assert sorted(jw) == sorted(tw) == ["wi8", "wsb"]
            np.testing.assert_array_equal(tw["wsb"].numpy(), np.asarray(jw["wsb"]))
            assert (tw["wi8"].numpy() != np.asarray(jw["wi8"])).mean() <= 1e-4


def test_generate_equals_manual_replay(setup):
    cfg, params, h = setup["cfg"], setup["qparams"], to_torch(setup["h"])
    prompt = torch.from_numpy(_tokens(5, 2, 6)).long()
    out = M.generate(cfg, params, prompt, h, steps=4, max_len=MAX_LEN,
                     quantized=True)
    assert tuple(out.shape) == (2, 4)
    logits, cache = M.prefill(cfg, params, prompt, h, max_len=MAX_LEN,
                              quantized=True)
    tok = logits.argmax(-1)
    manual = [tok]
    for i in range(3):
        logits, cache = M.decode_step(cfg, params, cache, tok, 6 + i, h,
                                      quantized=True)
        tok = logits.argmax(-1)
        manual.append(tok)
    np.testing.assert_array_equal(out.numpy(), torch.stack(manual, 1).numpy())


def test_ragged_lengths_match_per_row_runs(setup):
    cfg, params, h = setup["cfg"], setup["qparams"], to_torch(setup["h"])
    prompt = torch.from_numpy(_tokens(6, 3, 7)).long()
    lengths = torch.tensor([7, 3, 5])
    out = M.generate(cfg, params, prompt, h, steps=4, max_len=MAX_LEN,
                     lengths=lengths, quantized=True)
    for i, n in enumerate(lengths.tolist()):
        solo = M.generate(cfg, params, prompt[i:i + 1, :n], h, steps=4,
                          max_len=MAX_LEN, quantized=True)
        np.testing.assert_array_equal(out[i].numpy(), solo[0].numpy())


def test_generate_eos_padding_and_logprobs(setup):
    cfg, params, h = setup["cfg"], setup["qparams"], to_torch(setup["h"])
    prompt = torch.from_numpy(_tokens(7, 2, 5)).long()
    free, lps = M.generate(cfg, params, prompt, h, steps=5, max_len=MAX_LEN,
                           quantized=True, return_logprobs=True)
    assert torch.isfinite(lps).all() and (lps <= 0).all()
    eos = int(free[0, 1])
    out, lps2 = M.generate(cfg, params, prompt, h, steps=5, max_len=MAX_LEN,
                           quantized=True, eos_id=eos, pad_id=-1,
                           return_logprobs=True)
    row = out[0].tolist()
    first = row.index(eos)
    assert all(t == -1 for t in row[first + 1:])
    assert (lps2[0, first + 1:] == 0).all()
    np.testing.assert_array_equal(out[0, :first + 1].numpy(),
                                  free[0, :first + 1].numpy())


@pytest.mark.parametrize("bad", [dict(max_len=8), dict(lengths=[0, 5]),
                                 dict(lengths=[6, 5]), dict(lengths=[5, 5],
                                                            max_len=8)])
def test_generate_validates_cache_writes(setup, bad):
    kw = dict(steps=4, max_len=MAX_LEN)
    kw.update(bad)
    if "lengths" in kw:
        kw["lengths"] = torch.tensor(kw["lengths"])
    prompt = torch.zeros((2, 5), dtype=torch.long)
    with pytest.raises(ValueError):
        M.generate(setup["cfg"], setup["qparams"], prompt,
                   to_torch(setup["h"]), quantized=True, **kw)


def test_sample_logits_controls():
    logits = torch.tensor([[0.0, 5.0, 1.0, -2.0, 3.0]])
    g = torch.Generator().manual_seed(0)
    assert int(M.sample_logits(logits, g, temperature=0.0)[0]) == 1
    for _ in range(5):
        assert int(M.sample_logits(logits, g, temperature=1.0, top_k=1)[0]) == 1
        assert int(M.sample_logits(logits, g, temperature=1.0, top_p=0.05)[0]) == 1
    u = torch.zeros((1, 64))
    assert len({int(M.sample_logits(u, g)[0]) for _ in range(16)}) > 4
    lg = torch.arange(64, dtype=torch.float32)[None] * 0.1
    assert all(int(M.sample_logits(lg, g, temperature=5.0, top_k=8)[0]) >= 56
               for _ in range(16))


@pytest.mark.parametrize("temperature,top_k,top_p", [(0.0, 0, 1.0), (1.0, 1, 1.0),
                                                     (0.7, 1, 0.9), (1.0, 0, 1e-6),
                                                     (2.0, 3, 1e-6)])
def test_sample_logits_values_match_jax(temperature, top_k, top_p):
    """On the same logits, where the controls leave one candidate per row,
    the port's token ids equal JAX's in value; the port returns int64 (the
    type torch indexes with) where JAX returns int32."""
    from qutlass_tpu.models import sample_logits as j_sample_logits
    logits = np.random.default_rng(3).standard_normal((4, 97)).astype(np.float32) * 3
    want = np.asarray(j_sample_logits(jnp.asarray(logits), jax.random.PRNGKey(0),
                                      temperature=temperature, top_k=top_k, top_p=top_p))
    got = M.sample_logits(torch.from_numpy(logits), torch.Generator().manual_seed(0),
                          temperature=temperature, top_k=top_k, top_p=top_p)
    assert want.dtype == np.int32 and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(got.numpy(), logits.argmax(-1))


def test_quantized_linear_module(setup):
    w = setup["params"]["layers"][0]["q_proj"]
    h = to_torch(setup["h"])
    lin = QuantizedLinear.create(w, h)
    assert set(dict(lin.named_buffers())) == {"wi8", "wsb", "h"}
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((3, 5, 256))
                         ).to(torch.bfloat16)
    y = lin(x)
    assert tuple(y.shape) == (3, 5, w.shape[0])
    np.testing.assert_array_equal(to_np(y).view(np.uint16),
                                  to_np(mx_linear(x, lin.stored(), h)).view(np.uint16))
    fp4 = QuantizedLinear.create(w, h, weight_format="fp4")
    assert set(dict(fp4.named_buffers())) == {"wqt", "wst", "h"}
    # deficit <= 3: the int8 and fp4 evaluators agree bitwise
    np.testing.assert_array_equal(to_np(fp4(x)).view(np.uint16),
                                  to_np(y).view(np.uint16))


def test_init_params_seeded(setup):
    cfg = setup["cfg"]
    a = M.init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    b = M.init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    assert torch.equal(a["layers"][1]["down_proj"], b["layers"][1]["down_proj"])
    assert a["embed"].dtype == torch.bfloat16
    assert tuple(a["lm_head"].shape) == (cfg.vocab_size, cfg.hidden_size)
