"""The attention KV cache held in fp32, in the layout attention's batched
GEMMs read (``models.transformer.init_cache`` / ``_attend``).

Against a control that keeps a bf16 [B, L, KVH, D] cache, written and
read as the port did before, upcast in every step: the served logits of
``prefill`` and of dense and ragged ``decode_step`` bit for bit, on the
CPU at tiny sizes and, marked ``gpu`` (skipping without a card), at
Qwen3-8B's and LFM2-24B-A2B's heads with the step replayed as a CUDA
graph, at batch 4 with the cuBLAS kernels of a step the control's.  On the CPU too: a
decode step's ``_attend`` hands each einsum's one ``bmm`` the cache
itself, with no copy of it.  This file imports no JAX."""
import collections

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import qutlass_tpu_torch as qt
from qutlass_tpu_torch import models as M
from qutlass_tpu_torch.models import serving as S
from qutlass_tpu_torch.models import transformer as TF
import torch_helpers  # noqa: F401  (the worker's thread budget)

INIT_CACHE = TF.init_cache

LFM2_TYPES = ("conv", "attention", "conv", "attention")
# name -> (config, quantized); the LFM2-like model runs W4A4, as its expert layer must
CONFIGS = {
    "qwen3_rep1": (M.tiny_config(num_heads=4, num_kv_heads=4, head_dim=64), False),
    "qwen3_rep4": (M.tiny_config(num_heads=8, num_kv_heads=2, head_dim=32), False),
    "qwen3_window": (M.tiny_config(num_heads=8, num_kv_heads=2, head_dim=32,
                                   sliding_window=4), False),
    "lfm2_rep4": (M.tiny_config(num_layers=4, layer_types=LFM2_TYPES, num_heads=8,
                                num_kv_heads=2, head_dim=32, num_experts=4,
                                experts_per_token=2, expert_width=128, num_dense_layers=1,
                                tie_embeddings=True, rms_eps=1e-5), True),
}
# prompt lengths by batch: at batch 1 the control's upcast cache reaches
# the GEMM as a strided view (a batch of one needs no clone), at 3 as a copy
LENS = {"batch3": [9, 4, 1], "batch1": [9]}
STEPS = 4


# -- the control: the bf16 cache as the port kept it, upcast in every step --

def bf16_cache(cfg, batch, max_len, device=None):
    """``init_cache`` with each attention layer's k / v bf16 [B, max_len, KVH, D]."""
    cache = INIT_CACHE(cfg, batch, max_len, device)
    for c in cache:
        for n in ("k", "v") if "k" in c else ():
            c[n] = torch.zeros((batch, max_len, cfg.num_kv_heads, cfg.head_dim),
                               dtype=torch.bfloat16, device=c[n].device)
    return cache


def bf16_attend(cfg, qh, kc, vc, pos_limit):
    b, t = qh.shape[0], qh.shape[1]
    l = kc.shape[1]
    dev = qh.device
    rep = cfg.num_heads // cfg.num_kv_heads
    q5 = qh.reshape(b, t, cfg.num_kv_heads, rep, cfg.head_dim)
    scores = torch.einsum("btgrd,bsgd->bgrts", q5.to(torch.float32),
                          kc.to(torch.float32)) * (cfg.head_dim ** -0.5)
    pl = torch.as_tensor(pos_limit, device=dev)
    qpos = (pl[..., None] - t + torch.arange(t, device=dev)).expand(b, t)
    spos = torch.arange(l, device=dev)
    mask = spos[None, None, :] <= qpos[:, :, None]
    if cfg.sliding_window:
        mask &= spos[None, None, :] > qpos[:, :, None] - cfg.sliding_window
    scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrts,bsgd->btgrd", probs, vc.to(torch.float32))
    return out.reshape(b, t, cfg.num_heads, cfg.head_dim).to(torch.bfloat16)


def bf16_attention(cfg, layer, xin, cache_l, start_pos, h, method, quantized):
    b, t, _ = xin.shape
    qh, kh, vh = (TF._linear(xin, layer[p], h, method, quantized).reshape(b, t, -1, cfg.head_dim)
                  for p in ("q_proj", "k_proj", "v_proj"))
    if cfg.qk_norm:
        qh = TF._rms_norm(qh, layer["q_norm"], cfg.rms_eps)
        kh = TF._rms_norm(kh, layer["k_norm"], cfg.rms_eps)
    offsets = torch.arange(t, device=xin.device)
    dense = isinstance(start_pos, int)
    positions = start_pos + offsets if dense else start_pos[:, None] + offsets
    qh = TF._rope(qh, positions, cfg.rope_theta)
    kh = TF._rope(kh, positions, cfg.rope_theta)
    if dense:
        cache_l["k"][:, start_pos:start_pos + t] = kh
        cache_l["v"][:, start_pos:start_pos + t] = vh
    else:
        rows = torch.arange(b, device=xin.device)
        cache_l["k"][rows, start_pos] = kh[:, 0]
        cache_l["v"][rows, start_pos] = vh[:, 0]
    attn = bf16_attend(cfg, qh, cache_l["k"], cache_l["v"], start_pos + t)
    return TF._linear(attn.reshape(b, t, -1), layer["o_proj"], h, method, quantized)


def use_bf16_cache(mp):
    """The control in place of the cache that ``prefill`` builds and of the
    attention mixer that ``transformer._layer`` calls."""
    mp.setattr(S, "init_cache", bf16_cache)
    mp.setattr(TF, "_attention", bf16_attention)


# -- serving both ways --

def model(cfg, quantized, dev):
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    h = qt.hadamard_matrix(32, device=dev)
    if quantized:
        params = M.quantize_model_weights(cfg, params, h, weight_format="fp4")
    return params, h


def serve(cfg, params, h, quantized, ragged, dev, lens, step=M.decode_step):
    """Prefill, then STEPS greedy steps: the logits of every served
    position.  The cache holds one step more."""
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (len(lens), max(lens)), generator=g, device=dev)
    lengths = torch.tensor(lens, device=dev) if ragged else None
    logits, cache = M.prefill(cfg, params, toks, h, max_len=max(lens) + STEPS + 1,
                              quantized=quantized, lengths=lengths)
    out, tok = [logits], logits.argmax(-1)
    pos = lengths.clone() if ragged else max(lens)
    for _ in range(STEPS):
        logits, cache = step(cfg, params, cache, tok, pos, h, quantized=quantized)
        out.append(logits)
        tok, pos = logits.argmax(-1), pos + 1
    return out, cache


def eager_step(cfg, params, cache, tok, pos, h, quantized):
    return S._decode(cfg, params, cache, tok, pos, h, quantized, "quest"), cache


@pytest.fixture(scope="module", params=list(CONFIGS))
def cpu_model(request):
    cfg, quantized = CONFIGS[request.param]
    return (cfg, quantized, *model(cfg, quantized, torch.device("cpu")))


def test_init_cache_lays_out_the_gemm_operands():
    cfg, _ = CONFIGS["lfm2_rep4"]
    cache = TF.init_cache(cfg, 3, 10, device="cpu")
    k, v = cache[1]["k"], cache[1]["v"]
    assert k.shape == (3, 2, 32, 10) and v.shape == (3, 2, 10, 32)
    assert k.dtype == v.dtype == torch.float32 and k.is_contiguous() and v.is_contiguous()
    assert "k" not in cache[0] and cache[0]["conv"].dtype == torch.float32


@pytest.mark.parametrize("batch", list(LENS))
@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "dense"])
def test_served_logits_are_the_bf16_caches_bit_for_bit(cpu_model, ragged, batch, monkeypatch):
    """Prefill and decode steps (a [B] position, or an int) on the fp32
    cache against the bf16 cache upcast in every step: every served
    position's logits equal, and the cache holds the bf16 values."""
    cfg, quantized, params, h = cpu_model
    dev = torch.device("cpu")
    got, cache = serve(cfg, params, h, quantized, ragged, dev, LENS[batch])
    with monkeypatch.context() as mp:
        use_bf16_cache(mp)
        want, cache_c = serve(cfg, params, h, quantized, ragged, dev, LENS[batch])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for c, cc in zip(cache, cache_c):
        if "k" in c:
            assert torch.equal(c["k"].permute(0, 3, 1, 2), cc["k"].to(torch.float32))
            assert torch.equal(c["v"].permute(0, 2, 1, 3), cc["v"].to(torch.float32))


def attend_ops(attend, cfg, cache_l, b, pos):
    """One decode ``attend`` over ``cache_l``: its ``bmm`` calls, and its
    copies (``clone``, ``copy_``, ``_to_copy``) of a tensor of the cache's
    size (the other copies are of q, the scores and the output)."""
    qh = torch.randn((b, 1, cfg.num_heads, cfg.head_dim)).to(torch.bfloat16)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        attend(cfg, qh, cache_l["k"], cache_l["v"], pos)
    whole = cache_l["k"].numel()
    ops = collections.Counter(ev.name for ev in prof.events())
    copies = [ev.name for ev in prof.events()
              if ev.name in ("aten::clone", "aten::copy_", "aten::_to_copy")
              and ev.input_shapes and torch.Size(ev.input_shapes[0]).numel() == whole]
    return ops["aten::bmm"], copies


@pytest.mark.parametrize("pos", ["ragged", "dense"])
def test_decode_attend_hands_the_cache_itself_to_each_bmm(pos):
    """One ``bmm`` an einsum and no copy of the cache.  The bf16 cache is
    upcast and cloned into the GEMM's layout, k and v, in every step."""
    cfg = M.tiny_config(num_heads=8, num_kv_heads=2, head_dim=16)
    b, max_len = 3, 64
    p = torch.tensor([5, 63, 1]) if pos == "ragged" else 40
    cache = TF.init_cache(cfg, b, max_len, device="cpu")[0]
    assert attend_ops(TF._attend, cfg, cache, b, p) == (2, [])
    bmm, copies = attend_ops(bf16_attend, cfg, bf16_cache(cfg, b, max_len, device="cpu")[0], b, p)
    assert bmm == 2 and copies.count("aten::_to_copy") == copies.count("aten::clone") == 2


# -- on the card --

GPU_CONFIGS = {
    "qwen3_8b_heads": M.tiny_config(num_heads=32, num_kv_heads=8, head_dim=128),
    "lfm2_heads": M.tiny_config(num_layers=4, layer_types=LFM2_TYPES, num_heads=32,
                                num_kv_heads=8, head_dim=64, num_experts=8,
                                experts_per_token=4, expert_width=256, num_dense_layers=1,
                                tie_embeddings=True, rms_eps=1e-5),
}
# at batch 1 the control's upcast k reaches cuBLAS as a transposed view (a
# batch of one needs no clone) where the fp32 cache's does not: other
# kernels, the same bits
GPU_LENS = {"batch4": [300, 77, 5, 1], "batch1": [700]}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def cublas_kernels(cfg, params, cache, tok, pos, h):
    """The names of the library GEMM kernels of one eager decode step, in order."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        S._decode(cfg, params, cache, tok, pos, h, True, "quest")
        torch.cuda.synchronize()
    return [ev.name for ev in prof.events() if ev.device_type == DeviceType.CUDA
            and ("gemm" in ev.name or "gemv" in ev.name) and "fp4" not in ev.name]


@pytest.mark.gpu
@pytest.mark.parametrize("batch", list(GPU_LENS))
@pytest.mark.parametrize("name", list(GPU_CONFIGS))
def test_replayed_step_is_the_bf16_caches_bit_for_bit_on_the_card(dev, name, batch, monkeypatch):
    """Ragged prefill, then steps replayed as the cache's CUDA graph,
    against the bf16 cache's eager steps: every served position's logits
    equal; at batch 4 one more eager step each way launches the same
    cuBLAS kernels."""
    cfg, lens = GPU_CONFIGS[name], GPU_LENS[batch]
    params, h = model(cfg, True, dev)
    got, cache = serve(cfg, params, h, True, True, dev, lens)
    with monkeypatch.context() as mp:
        use_bf16_cache(mp)
        want, cache_c = serve(cfg, params, h, True, True, dev, lens, step=eager_step)
        tok = want[-1].argmax(-1)
        pos = torch.tensor(lens, device=dev) + STEPS
        names_c = cublas_kernels(cfg, params, cache_c, tok, pos, h)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    names = cublas_kernels(cfg, params, cache, tok, pos, h)
    assert names and names_c
    if len(lens) > 1:
        assert names == names_c
