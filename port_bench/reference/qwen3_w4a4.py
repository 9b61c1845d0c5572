"""Plain reference of a Qwen3 decoder whose seven projections are W4A4
linears (bf16 activations, fp32 attention and lm head, TF32 off).

Qwen3 as published: RMSNorm before attention and before the MLP, q/k
RMSNorm per head (``qk_norm``), rotary positions on both halves of each
head, grouped query attention, a SiLU-gated MLP, a final norm and an lm
head (the embedding where ``tie_word_embeddings``).  The configuration's
``quantization`` names the format, whose arithmetic is the module
``port_bench/reference/<format>.py``, the method and the rotation size.

It runs over prompts and the tokens served after them (teacher forced)
and gives the logits at every served position.  The fp4 linears are
exact (the format module's ``linear``), so they give the same bits at
any row count.
The fp32 parts (norms, rotary, attention, the head) are evaluated on the
shapes a server evaluates them on: the padded prompt batch at once, then
one position of each request at a time against a cache of ``max_len``
slots.  That is deliberate.  Thirty-six random-weight W4A4 layers turn
one flipped e2m1 code into a different trajectory, and one fp32 rounding
in another order flips a code now and then; only the same shapes give
the same roundings, and so a comparison that a lower precision fails.
"""
from __future__ import annotations

import importlib
from contextlib import contextmanager

import numpy as np
import torch


@contextmanager
def _tf32(on: bool):
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions on [B, T, H, D]: the halves (x1, x2) turn by
    position / theta^(2i / D); ``positions`` [T] or [B, T]."""
    d = x.shape[-1]
    inv = torch.tensor(1.0 / (theta ** (np.arange(0, d, 2) / d)), dtype=torch.float32,
                       device=x.device)
    ang = positions[..., None].to(torch.float32) * inv
    if positions.ndim == 1:
        ang = ang[None]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def attend(m: dict, qh, kc, vc, pos_limit) -> torch.Tensor:
    """Queries [B, T, H, D] (the last T positions before ``pos_limit``)
    against cached keys and values [B, L, KVH, D], causal, fp32."""
    b, t = qh.shape[0], qh.shape[1]
    l = kc.shape[1]
    g, hd = m["num_key_value_heads"], m["head_dim"]
    rep = m["num_attention_heads"] // g
    q5 = qh.reshape(b, t, g, rep, hd)
    scores = torch.einsum("btgrd,bsgd->bgrts", q5.to(torch.float32),
                          kc.to(torch.float32)) * (hd ** -0.5)
    pl = torch.as_tensor(pos_limit, device=qh.device)
    qpos = (pl[..., None] - t + torch.arange(t, device=qh.device)).expand(b, t)
    spos = torch.arange(l, device=qh.device)
    mask = spos[None, None, :] <= qpos[:, :, None]
    scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrts,bsgd->btgrd", probs, vc.to(torch.float32))
    return out.reshape(b, t, m["num_attention_heads"], hd).to(torch.bfloat16)


PROJECTIONS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


class _Seq:
    """One batch of requests: padded prompts [B, T], lengths [B], the
    tokens fed to decode [B, S], and its hidden states."""

    def __init__(self, embed, tokens, lengths, fed, max_len):
        self.lengths, self.max_len = lengths, max_len
        self.xp = embed[tokens]                                   # [B, T, D]
        self.xd = embed[fed]                                      # [B, S, D]
        self.b, self.t = tokens.shape
        self.s = fed.shape[1]


class Quant:
    """The configuration's quantization: the format's module, the method
    and the rotation."""

    def __init__(self, quant: dict, device):
        self.fmt = importlib.import_module(f"{__package__}.{quant['format']}")
        self.method = quant["method"]
        self.h = self.fmt.hadamard(quant["rotation_size"], device)

    def weight(self, w):
        return self.fmt.weight_f64(w, self.h, self.method)

    def act(self, x):
        """Activations [R, K] quantized and dequantized, exact fp64."""
        return self.fmt.dequantized_f64(x, self.h, self.method)

    def linear(self, x, w_dq):
        return self.fmt.linear(x, w_dq, self.h, self.method)


def _block(m: dict, seq: _Seq, W: dict, dq: dict, qz: Quant, tf32: bool) -> None:
    """One layer over a batch: the prefill at once, then each decode
    position against the cache, every projection exact on all rows."""
    b, t, s = seq.b, seq.t, seq.s
    d, hd = m["hidden_size"], m["head_dim"]
    nh, kvh = m["num_attention_heads"], m["num_key_value_heads"]
    eps, theta = m["rms_norm_eps"], m["rope_theta"]
    dev = seq.xp.device

    def per_step(x, fn):          # fn on each decode position, as [B, 1, ...]
        return torch.cat([fn(x[:, i:i + 1].contiguous()) for i in range(s)], 1) if s else x

    def rows_of(xp, xd):
        return torch.cat([xp.reshape(b * t, xp.shape[-1]), xd.reshape(b * s, xd.shape[-1])])

    def split(y, width):
        return y[:b * t].reshape(b, t, width), y[b * t:].reshape(b, s, width)

    xin = rows_of(rms_norm(seq.xp, W["input_norm"], eps),
                  per_step(seq.xd, lambda x: rms_norm(x, W["input_norm"], eps)))
    xq = qz.act(xin)
    proj = {n: (xq @ dq[n].T).to(torch.float32).to(torch.bfloat16)
            for n in ("q_proj", "k_proj", "v_proj")}
    qp, qd = split(proj["q_proj"], nh * hd)
    kp, kd = split(proj["k_proj"], kvh * hd)
    vp, vd = split(proj["v_proj"], kvh * hd)
    qp, qd = qp.reshape(b, t, nh, hd), qd.reshape(b, s, nh, hd)
    kp, kd = kp.reshape(b, t, kvh, hd), kd.reshape(b, s, kvh, hd)
    vp, vd = vp.reshape(b, t, kvh, hd), vd.reshape(b, s, kvh, hd)
    if m["qk_norm"]:
        qp, kp = rms_norm(qp, W["q_norm"], eps), rms_norm(kp, W["k_norm"], eps)
        qd = per_step(qd, lambda x: rms_norm(x, W["q_norm"], eps))
        kd = per_step(kd, lambda x: rms_norm(x, W["k_norm"], eps))

    kc = torch.zeros((b, seq.max_len, kvh, hd), dtype=torch.bfloat16, device=dev)
    vc = torch.zeros_like(kc)
    with _tf32(tf32):
        pos = torch.arange(t, device=dev)
        qp, kp = rope(qp, pos, theta), rope(kp, pos, theta)
        kc[:, 0:t] = kp
        vc[:, 0:t] = vp
        ap = attend(m, qp, kc, vc, t)
        ads = []
        rows = torch.arange(b, device=dev)
        for i in range(s):
            start = seq.lengths + i
            p = start[:, None] + torch.arange(1, device=dev)
            qi = rope(qd[:, i:i + 1].contiguous(), p, theta)
            ki = rope(kd[:, i:i + 1].contiguous(), p, theta)
            kc[rows, start] = ki[:, 0]
            vc[rows, start] = vd[:, i]
            ads.append(attend(m, qi, kc, vc, start + 1))
        ad = torch.cat(ads, 1) if s else seq.xd.new_zeros((b, 0, nh, hd))
    attn = rows_of(ap.reshape(b, t, nh * hd), ad.reshape(b, s, nh * hd))
    op, od = split(qz.linear(attn, dq["o_proj"]), d)
    xp, xd = seq.xp + op, seq.xd + od

    xin = rows_of(rms_norm(xp, W["post_attn_norm"], eps),
                  per_step(xd, lambda x: rms_norm(x, W["post_attn_norm"], eps)))
    xq = qz.act(xin)
    gate = (xq @ dq["gate_proj"].T).to(torch.float32).to(torch.bfloat16)
    up = (xq @ dq["up_proj"].T).to(torch.float32).to(torch.bfloat16)
    act = (torch.nn.functional.silu(gate.to(torch.float32)) * up.to(torch.float32)
           ).to(torch.bfloat16)
    mp, md = split(qz.linear(act, dq["down_proj"]), d)
    seq.xp, seq.xd = xp + mp, xd + md


def _logits(m, seq: _Seq, final_norm, head_f32, tf32: bool) -> list:
    """Logits [B, V] of each served position: the prompt's last token,
    then each decode position."""
    eps, b = m["rms_norm_eps"], seq.b
    last = seq.xp[torch.arange(b, device=seq.xp.device), seq.lengths - 1]
    out = []
    with _tf32(tf32):
        for x in [last] + [seq.xd[:, i] for i in range(seq.s)]:
            out.append(rms_norm(x, final_norm, eps).to(torch.float32) @ head_f32.T)
    return out


@torch.no_grad()
def served_logits(m: dict, quant: dict, layer_weights, embed, head, final_norm, batches,
                  variants=(False,)):
    """Logits at every served position of each batch.

    ``m`` is the configuration's ``model`` and ``quant`` its
    ``quantization``; ``layer_weights(i)`` gives layer i's bf16 weights;
    ``head`` is None where the embedding is tied to it; ``batches`` is a
    list of (padded prompts [B, T], lengths [B], served tokens [B, S + 1],
    max_len).  ``variants`` lists, for each pass, whether its fp32
    matmuls run in TF32 (the control).  Returns, per variant, per batch, a
    list of S + 1 logits [B, V] (fp32)."""
    qz = Quant(quant, embed.device)
    seqs = {v: [_Seq(embed, tok, lens, served[:, :-1], max_len)
                for tok, lens, served, max_len in batches] for v in variants}
    for i in range(m["num_hidden_layers"]):
        W = layer_weights(i)
        dq = {n: qz.weight(W[n]) for n in PROJECTIONS}
        for v in variants:
            for seq in seqs[v]:
                _block(m, seq, W, dq, qz, v)
        del W, dq
    head_f32 = (embed if head is None else head).to(torch.float32)
    return {v: [_logits(m, seq, final_norm, head_f32, v) for seq in seqs[v]]
            for v in variants}


def widest_gap(logits: list, served: torch.Tensor, chosen: list | None = None) -> float:
    """The widest gap by which a chosen token's reference logit lies below
    the reference's best, over the served positions of one batch.
    ``chosen`` defaults to the served tokens [B, S + 1]."""
    worst = 0.0
    for i, lg in enumerate(logits):
        tok = served[:, i] if chosen is None else chosen[i]
        gap = lg.max(dim=-1).values - lg.gather(1, tok[:, None].to(torch.int64))[:, 0]
        worst = max(worst, float(gap.max()))
    return worst
