"""Serving harness: KV-cache prefill + autoregressive decode (counterpart
of ``qutlass_tpu.models.serving``, whose cache is bf16).

``generate`` is a host loop with the semantics of the JAX package's
dispatch loop: prefill, then one decode step per emitted token, every
projection on its stored W4A4 path (MXFP4 or NVFP4, chosen by the
stored leaves in ``transformer._linear``) when ``quantized``.  Unlike
the JAX package, the KV cache is updated IN PLACE (``_block`` writes
into the cache tensors and returns the same dict), which saves a copy of
the cache per layer per step; ``prefill`` always builds a fresh cache.

A ragged decode step on the card is a CUDA graph of its cache: captured
on the cache's first step, replayed on every later one (``decode_step``).

The cache holds each layer's own state: keys and values (``k``, ``v``) of
an attention layer, the last conv inputs (``conv``) of a short-conv layer
(``models/shortconv.py``).  Keys and values are the bf16 values of the
projections, held in fp32 and laid out as attention's two batched GEMMs
read them (``init_cache``), so ``_attend`` hands cuBLAS the cache itself:
no upcast and no copy of it in a step.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.weak import WeakIdKeyDictionary

from .. import utils
from ..ops import dispatch
from ..ops.dispatch import span
from .shortconv import CONV_WIDTH
from .transformer import ModelConfig, _head_logits, _layer, _linear, _rms_norm, _rope

# the decode step's CUDA graph of each cache, keyed by the cache's first
# state tensor: it and its memory pool go with the cache
_GRAPHS = WeakIdKeyDictionary()
_CAPTURE_STREAMS: dict = {}        # device -> the stream graphs are captured on


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> list:
    """Per-layer state, fp32 zeros, on the card unless ``device`` says
    otherwise: an attention layer's k [B, kv_heads, head_dim, max_len] and
    v [B, kv_heads, max_len, head_dim], a short-conv layer's ``conv``
    [B, CONV_WIDTH - 1, hidden].

    k and v hold bf16 values exactly.  Their layouts are the operands of
    ``_attend``'s two batched GEMMs, batch (b, kv head) outermost: k as
    the scores' [D, L] factor, v as the output's [L, D] factor.  k in v's
    layout would reach the GEMM transposed, which sums in another order."""
    device = utils.resolve_device(device)
    g, d = cfg.num_kv_heads, cfg.head_dim

    def state(i):
        if cfg.mixer(i) == "conv":
            return {"conv": torch.zeros((batch, CONV_WIDTH - 1, cfg.hidden_size),
                                        dtype=torch.float32, device=device)}
        return {"k": torch.zeros((batch, g, d, max_len), dtype=torch.float32, device=device),
                "v": torch.zeros((batch, g, max_len, d), dtype=torch.float32, device=device)}
    return [state(i) for i in range(cfg.num_layers)]


@span("qt.attend")
def _attend(cfg: ModelConfig, qh, kc, vc, pos_limit) -> torch.Tensor:
    """q [B, T, H, D] against the fp32 cache, k [B, KVH, D, L] and v
    [B, KVH, L, D] (``init_cache``), masked to positions < pos_limit +
    per-query causality offset (and to the sliding window).
    ``pos_limit``: int, or [B] for ragged batches."""
    b, t = qh.shape[0], qh.shape[1]
    l = kc.shape[-1]
    dev = qh.device
    rep = cfg.num_heads // cfg.num_kv_heads
    q5 = qh.reshape(b, t, cfg.num_kv_heads, rep, cfg.head_dim)
    scores = torch.einsum("btgrd,bsgd->bgrts", q5.to(torch.float32),
                          kc.permute(0, 3, 1, 2)) * (cfg.head_dim ** -0.5)
    pl = torch.as_tensor(pos_limit, device=dev)
    qpos = pl[..., None] - t + torch.arange(t, device=dev)   # [t] or [B, t]
    qpos = qpos.expand(b, t)
    spos = torch.arange(l, device=dev)
    mask = spos[None, None, :] <= qpos[:, :, None]            # [b, t, l]
    if cfg.sliding_window:
        mask &= spos[None, None, :] > qpos[:, :, None] - cfg.sliding_window
    scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrts,bsgd->btgrd", probs, vc.permute(0, 2, 1, 3))
    return out.reshape(b, t, cfg.num_heads, cfg.head_dim).to(torch.bfloat16)


def _block(cfg: ModelConfig, layer: dict, x: torch.Tensor, cache_l: dict,
           start_pos, h, method: str, quantized: bool, lengths=None):
    """One transformer block over x [B, T, D], writing the layer's state:
    the KV cache at positions [start_pos, start_pos + T), or the conv
    state (each row's at ``lengths`` [B] in a ragged prefill).
    ``start_pos`` is an int, or a [B] tensor for ragged decode (then T
    must be 1)."""
    def attention(layer, xin):
        return _attention(cfg, layer, xin, cache_l, start_pos, h, method, quantized)
    return _layer(cfg, layer, x, attention, cache_l.get("conv"), h, method, quantized,
                  lengths), cache_l


def _attention(cfg: ModelConfig, layer: dict, xin: torch.Tensor, cache_l: dict,
               start_pos, h, method: str, quantized: bool) -> torch.Tensor:
    """The attention mixer over the normed xin [B, T, D], through o_proj."""
    b, t, _ = xin.shape
    qh = _linear(xin, layer["q_proj"], h, method, quantized)
    kh = _linear(xin, layer["k_proj"], h, method, quantized)
    vh = _linear(xin, layer["v_proj"], h, method, quantized)
    qh = qh.reshape(b, t, cfg.num_heads, cfg.head_dim)
    kh = kh.reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    vh = vh.reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        qh = _rms_norm(qh, layer["q_norm"], cfg.rms_eps)
        kh = _rms_norm(kh, layer["k_norm"], cfg.rms_eps)
    offsets = torch.arange(t, device=xin.device)
    dense = isinstance(start_pos, int)
    positions = start_pos + offsets if dense else start_pos[:, None] + offsets
    qh = _rope(qh, positions, cfg.rope_theta)
    kh = _rope(kh, positions, cfg.rope_theta)
    if dense:
        cache_l["k"][..., start_pos:start_pos + t] = kh.permute(0, 2, 3, 1)
        cache_l["v"][:, :, start_pos:start_pos + t] = vh.transpose(1, 2)
    else:                                  # ragged decode: one row each
        rows = torch.arange(b, device=xin.device)   # index_put_ takes one dtype: cast the rows
        cache_l["k"][rows, :, :, start_pos] = kh[:, 0].to(torch.float32)
        cache_l["v"][rows, :, start_pos] = vh[:, 0].to(torch.float32)
    attn = _attend(cfg, qh, cache_l["k"], cache_l["v"], start_pos + t)
    attn = attn.reshape(b, t, cfg.num_heads * cfg.head_dim)
    return _linear(attn, layer["o_proj"], h, method, quantized)


def _logits(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = _rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _head_logits(x, params.get("lm_head", params["embed"]))


@span("qt.prefill")
@torch.no_grad()
def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor, h=None, *,
            max_len: int, quantized: bool = False, method: str = "quest",
            lengths: torch.Tensor | None = None):
    """Prefill [B, T] prompt -> (last-position logits [B, vocab], cache).

    ``lengths`` [B] enables ragged batches: prompts are right-padded to
    T and each row's logits are read at ``lengths[b] - 1``; the pad
    positions' cache slots are overwritten by decode before any query
    attends to them, and a conv layer keeps each row's inputs before
    ``lengths[b]``.
    """
    b, _ = tokens.shape
    cache = init_cache(cfg, b, max_len, tokens.device)
    x = params["embed"][tokens]
    for layer, cache_l in zip(params["layers"], cache):
        x, _ = _block(cfg, layer, x, cache_l, 0, h, method, quantized, lengths)
    last = (x[:, -1] if lengths is None
            else x[torch.arange(b, device=x.device), lengths - 1])
    return _logits(cfg, params, last), cache


def _decode(cfg: ModelConfig, params: dict, cache: list, token, pos, h,
            quantized: bool, method: str) -> torch.Tensor:
    """The decode step's body: logits [B, vocab], the cache written in place."""
    x = params["embed"][token][:, None]                   # [B, 1, D]
    for layer, cache_l in zip(params["layers"], cache):
        x, _ = _block(cfg, layer, x, cache_l, pos, h, method, quantized)
    return _logits(cfg, params, x[:, 0])


@dataclasses.dataclass
class _Graph:
    """A cache's captured decode step, its static inputs and output, the
    launches it makes, and what it was captured for.  It holds ``params``
    (the graph reads their memory) but not the cache."""
    key: tuple
    params: dict
    graph: torch.cuda.CUDAGraph
    token: torch.Tensor
    pos: torch.Tensor
    logits: torch.Tensor
    launches: dict


def _first_state(cache: list) -> torch.Tensor:
    """The cache's first state tensor, whatever its layer's kind: it keys
    the cache's graph."""
    return next(iter(cache[0].values()))


def _graph_key(cfg, cache, token, pos, h, quantized, method) -> tuple:
    return (cfg, None if h is None else h.data_ptr(), token.shape[0], quantized, method,
            token.dtype, pos.dtype, tuple(t.data_ptr() for c in cache for t in c.values()))


@span("qt.graph_capture")
def _capture(cfg, params, cache, token, pos, h, quantized, method, key) -> tuple:
    """The cache's first step: the eager step on the capture stream (its
    logits are this step's), then the step's capture into static token,
    position and logits buffers.  Nothing runs during the capture: the
    cache is written once.  Returns (logits, _Graph)."""
    dev = token.device
    stream = _CAPTURE_STREAMS.get(dev)
    if stream is None:
        stream = _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
    cur = torch.cuda.current_stream(dev)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        logits = _decode(cfg, params, cache, token, pos, h, quantized, method)
    cur.wait_stream(stream)
    logits.record_stream(cur)
    token, pos = token.clone(), pos.clone()
    before = dict(dispatch.launch_counts)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = _decode(cfg, params, cache, token, pos, h, quantized, method)
    # a replay launches what the capture noted: count it there, not here
    launches = {k: n - before[k] for k, n in dispatch.launch_counts.items() if n != before[k]}
    dispatch.launch_counts.update(before)
    return logits, _Graph(key, params, graph, token, pos, out, launches)


@span("qt.graph_replay")
def _replay(entry: _Graph, token, pos) -> torch.Tensor:
    entry.token.copy_(token)
    entry.pos.copy_(pos)
    entry.graph.replay()
    for k, n in entry.launches.items():
        dispatch.launch_counts[k] += n
    return entry.logits.clone()         # the caller's own: the next replay rewrites entry.logits


@span("qt.decode_step")
@torch.no_grad()
def decode_step(cfg: ModelConfig, params: dict, cache: list, token, pos, h=None,
                *, quantized: bool = False, method: str = "quest"):
    """One decode step: token [B] at position ``pos`` (an int, or a [B]
    tensor for ragged batches).  Returns (logits [B, vocab], cache),
    the cache updated in place.

    A ragged step on the card (``pos`` a [B] tensor, the tensors on CUDA,
    the stream not capturing) runs as one CUDA graph of its cache: the
    cache's first step runs eagerly and captures the step, every later
    step copies ``token`` and ``pos`` in and replays it, the same kernels
    bit for bit.  A change of ``params``, ``h``, the batch, ``quantized``,
    ``method``, the inputs' dtypes or the cache's tensors captures anew.
    An int ``pos`` and CPU tensors run eagerly."""
    args = (cfg, params, cache, token, pos, h, quantized, method)
    first = _first_state(cache)
    if not (isinstance(pos, torch.Tensor) and pos.ndim == 1
            and all(t.is_cuda for t in (token, pos, first, params["embed"]))
            and not torch.cuda.is_current_stream_capturing()):
        return _decode(*args), cache
    key = _graph_key(cfg, cache, token, pos, h, quantized, method)
    entry = _GRAPHS.get(first)
    if entry is None or entry.key != key or entry.params is not params:
        logits, _GRAPHS[first] = _capture(*args, key)
        return logits, cache
    return _replay(entry, token, pos), cache


def sample_logits(logits: torch.Tensor, generator: torch.Generator | None = None,
                  *, temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """Sample token ids [B] from logits [B, V]: temperature 0 is greedy
    argmax; top_k keeps the k highest logits (0 = all); top_p keeps the
    smallest prefix of the sorted distribution reaching top_p.

    The ids are int64, where the JAX package's ``sample_logits`` returns
    int32: ``torch.argmax`` and ``torch.multinomial`` give int64, the type
    torch indexes with (the embedding lookup and the cache writes take
    the ids as they are).  Compare values, not dtypes, with JAX."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.to(torch.float32) / temperature
    if top_k and top_k > 0:
        k = min(top_k, logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p < 1.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        keep = probs.cumsum(-1) - probs < top_p
        cutoff = torch.where(keep, srt, torch.full_like(srt, float("inf"))
                             ).amin(-1, keepdim=True)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _logprob(logits: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return lp.gather(-1, token[:, None])[:, 0]


@torch.no_grad()
def generate(cfg: ModelConfig, params: dict, prompt: torch.Tensor, h=None, *,
             steps: int, max_len: int, lengths: torch.Tensor | None = None,
             quantized: bool = False, method: str = "quest",
             generator: torch.Generator | None = None,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
             eos_id: int | None = None, pad_id: int = 0,
             return_logprobs: bool = False):
    """Autoregressive generation: prompt [B, T] -> tokens [B, steps].

    Greedy by default; pass ``generator`` with ``temperature`` / ``top_k``
    / ``top_p`` to sample.  ``eos_id`` pads each row with ``pad_id`` after
    its first end-of-sequence token (fixed ``steps`` iterations, no early
    exit).  ``lengths`` [B] serves right-padded ragged prompts.
    ``return_logprobs=True`` also returns each emitted token's
    log-probability under the untempered softmax (0.0 after EOS).

    The tokens are int64 (``sample_logits``'s ids), where the JAX
    package's ``generate`` returns int32: int64 is the type torch indexes
    the embedding and the cache with.

    The cache writes are validated here on the host, so an undersized
    ``max_len`` or bad ``lengths`` raise instead of writing out of range.
    """
    b, t = prompt.shape
    if lengths is None:
        if t + steps > max_len:
            raise ValueError(
                f"max_len={max_len} < prompt_len({t}) + steps({steps}): "
                "the KV cache cannot hold the generated positions")
    else:
        lo, hi = int(lengths.min()), int(lengths.max())
        if lo < 1 or hi > t:
            raise ValueError(f"lengths must satisfy 1 <= lengths <= T({t}); "
                             f"got range [{lo}, {hi}]")
        if hi + steps > max_len:
            raise ValueError(
                f"max_len={max_len} < max(lengths)({hi}) + steps({steps}): "
                "ragged cache writes would fall outside the cache")

    def pick(logits):
        return sample_logits(logits, generator, temperature=temperature,
                             top_k=top_k, top_p=top_p)

    logits, cache = prefill(cfg, params, prompt, h, max_len=max_len,
                            quantized=quantized, method=method, lengths=lengths)
    token = pick(logits)
    lp = (_logprob(logits, token) if return_logprobs
          else torch.zeros((b,), device=prompt.device))
    done = torch.zeros((b,), dtype=torch.bool, device=prompt.device)
    pos = t if lengths is None else lengths.to(torch.long)
    toks, lps = [], []
    for _ in range(steps):
        logits, cache = decode_step(cfg, params, cache, token, pos, h,
                                    quantized=quantized, method=method)
        nxt = pick(logits)
        nlp = _logprob(logits, nxt) if return_logprobs else lp
        toks.append(torch.where(done, torch.full_like(token, pad_id), token))
        lps.append(torch.where(done, torch.zeros_like(lp), lp))
        if eos_id is not None:
            done = done | (token == eos_id)
        token, lp, pos = nxt, nlp, pos + 1
    out = torch.stack(toks, dim=1)
    return (out, torch.stack(lps, dim=1)) if return_logprobs else out
