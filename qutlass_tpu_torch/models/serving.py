"""Serving harness: KV-cache prefill + autoregressive decode (counterpart
of ``qutlass_tpu.models.serving``, whose cache is bf16).

``generate`` is a host loop with the semantics of the JAX package's
dispatch loop: prefill, then one decode step per emitted token, every
projection on its stored W4A4 path (MXFP4 or NVFP4, chosen by the
stored leaves in ``transformer._linear``) when ``quantized``.  Unlike
the JAX package, the cache is updated IN PLACE (``transformer._layer``
writes each layer's state into the cache tensors), which saves a copy of
the cache per layer per step; ``prefill`` always builds a fresh cache.

A ragged decode step on the card is a CUDA graph of its cache: captured
on the cache's first step, replayed on every later one (``decode_step``).

The cache (``transformer.init_cache``) holds each layer's own state: keys
and values (``k``, ``v``) of an attention layer, the last conv inputs
(``conv``) of a short-conv layer (``models/shortconv.py``).  Keys and
values are the bf16 values of the projections, held in fp32 and laid out
as attention's two batched GEMMs read them, so ``transformer._attend``
hands cuBLAS the cache itself: no upcast and no copy of it in a step.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..ops import dispatch
from ..ops.dispatch import span
from .transformer import ModelConfig, _layer, _logits, init_cache

# the decode step's CUDA graph of each cache, keyed by the cache's first
# state tensor: it and its memory pool go with the cache
_GRAPHS = WeakIdKeyDictionary()
_CAPTURE_STREAMS: dict = {}        # device -> the stream graphs are captured on


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
    for layer, state in zip(params["layers"], cache):
        x = _layer(cfg, layer, x, state, 0, h, method, quantized, lengths)
    last = (x[:, -1] if lengths is None
            else x[torch.arange(b, device=x.device), lengths - 1])
    return _logits(cfg, params, last), cache


def _decode(cfg: ModelConfig, params: dict, cache: list, token, pos, h,
            quantized: bool, method: str) -> torch.Tensor:
    """The decode step's body: logits [B, vocab], the cache written in place."""
    x = params["embed"][token][:, None]                   # [B, 1, D]
    for layer, state in zip(params["layers"], cache):
        x = _layer(cfg, layer, x, state, pos, h, method, quantized)
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
