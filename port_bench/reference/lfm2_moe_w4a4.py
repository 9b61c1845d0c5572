"""Plain reference of LFM2-MoE (model_type ``lfm2_moe``, e.g.
LiquidAI/LFM2-24B-A2B) whose projections are W4A4 linears (bf16
activations, fp32 mixing, attention, router and lm head, TF32 off).

The architecture, as Hugging Face's ``modeling_lfm2.py`` (4.57) writes the
dense block and the source's model_type its sparse block:

- ``x = embed(tokens)``; each layer ``h = x + mixer(operator_norm(x))``,
  then ``h + ffn(ffn_norm(h))``; a final ``embedding_norm``; the head is the
  embedding (``tie_word_embeddings``, the ``lfm2`` family's default).
  RMSNorm is ``weight * norm(x)`` (the norm in fp32, rounded to bf16 first).
- mixer, by ``layer_types``: ``conv`` is ``Lfm2ShortConv``: ``B, C, x =
  in_proj(h).chunk(3)``, ``Bx = B x``, a depthwise causal conv of
  ``conv_L_cache`` taps over positions (no bias; out[t] = sum_j w[j]
  Bx[t - L + 1 + j]), ``y = out_proj(C conv(Bx))``.  ``full_attention`` is
  ``Lfm2Attention``: q/k/v, per-head RMSNorm of q and k, rotary positions
  (theta ``rope_parameters.rope_theta``) on both halves of each head, grouped
  query attention with head_dim = hidden / heads, ``out_proj``.
- ffn: the first ``num_dense_layers`` a SwiGLU ``w2(silu(w1 x) * w3 x)`` of
  width ``intermediate_size``; the others the sparse block: ``s =
  sigmoid(x Wg^T)`` (router [E, D], no bias), the top ``num_experts_per_tok``
  experts chosen on ``s + expert_bias`` (a selection-only bias,
  ``use_expert_bias``), weights the chosen ``s`` over ``(their sum + 1e-6)``
  (``norm_topk_prob``) times ``routed_scaling_factor``, ``y = sum_j w_j
  expert_{e_j}(x)``, each expert a SwiGLU of width ``moe_intermediate_size``.

Departures, each the configuration's stated precision: every projection
(q, k, v, out, conv in and out, dense and expert w1, w3, w2) is a W4A4
linear with the format's exact arithmetic (``reference/<format>.py``);
``B x``, the taps (oldest first) and ``C conv`` are fp32, rounded to bf16
before ``out_proj`` (Hugging Face keeps them in the model's dtype); the
router's product, the sigmoid, the top k and the weights are fp32, the sum
over the chosen in top-k order; a token's expert outputs are weighted and
summed in fp32 in top-k order, then rounded to bf16 (Hugging Face adds
each expert's weighted output into a buffer of the model's dtype).

It runs over prompts and the tokens served after them (teacher forced)
and gives the logits at every served position.  As in ``qwen3_w4a4.py``,
the fp4 linears are exact at any row count, and the fp32 parts (norms, the
router's product, attention, the head) are evaluated on the shapes a
server evaluates them on: the padded prompt batch at once, then one
position of each request at a time against a cache of ``max_len`` slots;
the conv, the sigmoid, the top k and the combine are elementwise or per
row.  So routing and codes agree bit for bit, and a lower precision fails.
"""
from __future__ import annotations

import torch

from .qwen3_w4a4 import Quant, _Seq, _tf32, attend, rms_norm, rope, widest_gap

__all__ = ["served_logits", "widest_gap", "route"]


def _head_dim(m: dict) -> int:
    return m["hidden_size"] // m["num_attention_heads"]


class _Rows:
    """Row bookkeeping of one batch: the prefill's B T rows, then the
    decode positions' B S rows."""

    def __init__(self, seq: _Seq):
        self.seq = seq
        self.b, self.t, self.s = seq.b, seq.t, seq.s

    def cat(self, xp, xd):
        return torch.cat([xp.reshape(self.b * self.t, -1), xd.reshape(self.b * self.s, -1)])

    def split(self, y):
        w = y.shape[-1]
        n = self.b * self.t
        return y[:n].reshape(self.b, self.t, w), y[n:].reshape(self.b, self.s, w)

    def per_step(self, x, fn):
        """fn on each decode position as [B, 1, ...]."""
        if not self.s:
            return x
        return torch.cat([fn(x[:, i:i + 1].contiguous()) for i in range(self.s)], 1)

    def norm(self, xp, xd, w, eps):
        return self.cat(rms_norm(xp, w, eps), self.per_step(xd, lambda x: rms_norm(x, w, eps)))


def _conv(m: dict, rs: _Rows, W: dict, dq: dict, qz: Quant) -> tuple:
    seq, b, t, s = rs.seq, rs.b, rs.t, rs.s
    width = m["conv_L_cache"]
    xin = rs.norm(seq.xp, seq.xd, W["input_norm"], m["norm_eps"])
    bcx_p, bcx_d = rs.split(qz.linear(xin, dq["in_proj"]))
    taps = W["conv"].to(torch.float32)                        # [D, L]

    def gate(bcx):
        bg, cg, xg = bcx.chunk(3, dim=-1)
        return bg.to(torch.float32) * xg.to(torch.float32), cg

    bx_p, c_p = gate(bcx_p)
    bx_d, c_d = gate(bcx_d)
    d = bx_p.shape[-1]
    # the prompt batch as the server runs it, from zeros
    full = torch.cat([bx_p.new_zeros((b, width - 1, d)), bx_p], 1)
    conv_p = full[:, 0:t] * taps[:, 0]
    for j in range(1, width):
        conv_p = conv_p + full[:, j:j + t] * taps[:, j]
    # each row's own sequence: zeros, its prompt's inputs, its decode inputs
    hist = torch.zeros((b, width - 1 + t + s, d), dtype=torch.float32, device=full.device)
    for r in range(b):
        n = int(seq.lengths[r])
        hist[r, width - 1:width - 1 + n] = bx_p[r, :n]
        hist[r, width - 1 + n:width - 1 + n + s] = bx_d[r]
    at = seq.lengths[:, None] + torch.arange(s, device=full.device)        # [B, S]

    def tap(j):
        return hist.gather(1, (at + j)[..., None].expand(b, s, d)) * taps[:, j]

    conv_d = tap(0)
    for j in range(1, width):
        conv_d = conv_d + tap(j)
    y = rs.cat((c_p.to(torch.float32) * conv_p).to(torch.bfloat16),
               (c_d.to(torch.float32) * conv_d).to(torch.bfloat16))
    return rs.split(qz.linear(y, dq["out_proj"]))


def _attention(m: dict, rs: _Rows, W: dict, dq: dict, qz: Quant, tf32: bool) -> tuple:
    seq, b, t, s = rs.seq, rs.b, rs.t, rs.s
    mq = dict(m, head_dim=_head_dim(m))
    hd, nh, kvh = mq["head_dim"], m["num_attention_heads"], m["num_key_value_heads"]
    eps, theta = m["norm_eps"], m["rope_parameters"]["rope_theta"]
    dev = seq.xp.device
    xq = qz.act(rs.norm(seq.xp, seq.xd, W["input_norm"], eps))
    proj = {n: (xq @ dq[n].T).to(torch.float32).to(torch.bfloat16)
            for n in ("q_proj", "k_proj", "v_proj")}
    qp, qd = rs.split(proj["q_proj"])
    kp, kd = rs.split(proj["k_proj"])
    vp, vd = rs.split(proj["v_proj"])
    qp, qd = qp.reshape(b, t, nh, hd), qd.reshape(b, s, nh, hd)
    kp, kd = kp.reshape(b, t, kvh, hd), kd.reshape(b, s, kvh, hd)
    vp, vd = vp.reshape(b, t, kvh, hd), vd.reshape(b, s, kvh, hd)
    qp, kp = rms_norm(qp, W["q_norm"], eps), rms_norm(kp, W["k_norm"], eps)
    qd = rs.per_step(qd, lambda x: rms_norm(x, W["q_norm"], eps))
    kd = rs.per_step(kd, lambda x: rms_norm(x, W["k_norm"], eps))
    kc = torch.zeros((b, seq.max_len, kvh, hd), dtype=torch.bfloat16, device=dev)
    vc = torch.zeros_like(kc)
    with _tf32(tf32):
        pos = torch.arange(t, device=dev)
        qp, kp = rope(qp, pos, theta), rope(kp, pos, theta)
        kc[:, 0:t] = kp
        vc[:, 0:t] = vp
        ap = attend(mq, qp, kc, vc, t)
        ads = []
        rows = torch.arange(b, device=dev)
        for i in range(s):
            start = seq.lengths + i
            p = start[:, None] + torch.arange(1, device=dev)
            qi = rope(qd[:, i:i + 1].contiguous(), p, theta)
            ki = rope(kd[:, i:i + 1].contiguous(), p, theta)
            kc[rows, start] = ki[:, 0]
            vc[rows, start] = vd[:, i]
            ads.append(attend(mq, qi, kc, vc, start + 1))
        ad = torch.cat(ads, 1) if s else seq.xd.new_zeros((b, 0, nh, hd))
    attn = rs.cat(ap.reshape(b, t, nh * hd), ad.reshape(b, s, nh * hd))
    return rs.split(qz.linear(attn, dq["o_proj"]))


def _swiglu(gate, up):
    return (torch.nn.functional.silu(gate.to(torch.float32)) * up.to(torch.float32)
            ).to(torch.bfloat16)


def _dense(rs: _Rows, xin, dq: dict, qz: Quant) -> tuple:
    xq = qz.act(xin)
    gate = (xq @ dq["gate_proj"].T).to(torch.float32).to(torch.bfloat16)
    up = (xq @ dq["up_proj"].T).to(torch.float32).to(torch.bfloat16)
    return rs.split(qz.linear(_swiglu(gate, up), dq["down_proj"]))


def route(m: dict, logits: torch.Tensor, bias) -> tuple:
    """(experts [R, k] in top-k order, weights [R, k] fp32) from the
    router's fp32 logits [R, E]."""
    s = torch.sigmoid(logits)
    sel = s + bias if m["use_expert_bias"] else s
    idx = torch.topk(sel, m["num_experts_per_tok"], dim=-1).indices
    w = s.gather(1, idx)
    if m["norm_topk_prob"]:
        total = w[:, 0]
        for j in range(1, w.shape[1]):
            total = total + w[:, j]
        w = w / (total + 1e-6)[:, None]
    return idx, w * m["routed_scaling_factor"]


def _experts(m: dict, rs: _Rows, xin, W: dict, dq: dict, qz: Quant, tf32: bool) -> tuple:
    b, t = rs.b, rs.t
    wr = W["router"].to(torch.float32)
    xp, xd = rs.split(xin)
    with _tf32(tf32):          # the router's product on the server's shapes
        logits = [xp.reshape(b * t, -1).to(torch.float32) @ wr.T]
        logits += [xd[:, i].contiguous().to(torch.float32) @ wr.T for i in range(rs.s)]
    lp, ld = logits[0], logits[1:]
    # rows in the order of _Rows: the prefill's, then decode step by step per row
    ld = torch.stack(ld, 1).reshape(b * rs.s, -1) if ld else lp[:0]
    idx, w = route(m, torch.cat([lp, ld]), W.get("expert_bias"))
    k = idx.shape[1]
    xq = qz.act(xin)

    def per_expert(xrows, wdq, rows_of):
        """out[r, j] = the exact linear of row rows_of(r, j) against expert idx[r, j]."""
        out = torch.empty((idx.shape[0], k, wdq.shape[1]), dtype=torch.bfloat16,
                          device=xin.device)
        for e in range(wdq.shape[0]):
            r, j = torch.nonzero(idx == e, as_tuple=True)
            if r.numel():
                y = xrows[rows_of(r, j)] @ wdq[e].T
                out[r, j] = y.to(torch.float32).to(torch.bfloat16)
        return out

    gate = per_expert(xq, dq["gate_proj"], lambda r, j: r)
    up = per_expert(xq, dq["up_proj"], lambda r, j: r)
    act = _swiglu(gate, up)                                   # [R, k, F]
    aq = qz.act(act.reshape(-1, act.shape[-1]))
    down = per_expert(aq, dq["down_proj"], lambda r, j: r * k + j).to(torch.float32)
    acc = down[:, 0] * w[:, 0:1]
    for j in range(1, k):
        acc = acc + down[:, j] * w[:, j:j + 1]
    # back to _Rows' order: decode rows are [B, S] row-major there too
    return rs.split(acc.to(torch.bfloat16))


def _layer(m: dict, i: int, rs: _Rows, W: dict, dq: dict, qz: Quant, tf32: bool) -> None:
    seq = rs.seq
    if m["layer_types"][i] == "conv":
        op, od = _conv(m, rs, W, dq, qz)
    else:
        op, od = _attention(m, rs, W, dq, qz, tf32)
    xp, xd = seq.xp + op, seq.xd + od
    xin = rs.norm(xp, xd, W["post_attn_norm"], m["norm_eps"])
    if i < m["num_dense_layers"]:
        mp, md = _dense(rs, xin, dq, qz)
    else:
        mp, md = _experts(m, rs, xin, W, dq, qz, tf32)
    seq.xp, seq.xd = xp + mp, xd + md


def _dequantized(W: dict, qz: Quant) -> dict:
    dq = {n: qz.weight(W[n]) for n in ("in_proj", "out_proj", "q_proj", "k_proj", "v_proj",
                                      "o_proj", "gate_proj", "up_proj", "down_proj") if n in W}
    if "experts" in W:
        for n, w in W["experts"].items():
            e, f, d = w.shape
            dq[n] = qz.weight(w.reshape(e * f, d)).view(e, f, d)
    return dq


def _logits(m: dict, seq: _Seq, final_norm, head_f32, tf32: bool) -> list:
    last = seq.xp[torch.arange(seq.b, device=seq.xp.device), seq.lengths - 1]
    out = []
    with _tf32(tf32):
        for x in [last] + [seq.xd[:, i] for i in range(seq.s)]:
            out.append(rms_norm(x, final_norm, m["norm_eps"]).to(torch.float32) @ head_f32.T)
    return out


@torch.no_grad()
def served_logits(m: dict, quant: dict, layer_weights, embed, head, final_norm, batches,
                  variants=(False,)):
    """Logits at every served position of each batch, as
    ``qwen3_w4a4.served_logits``: ``m`` the configuration's ``model``,
    ``quant`` its ``quantization``, ``layer_weights(i)`` layer i's weights
    (bf16, the experts stacked [E, N, K], ``expert_bias`` fp32), ``head``
    None where tied, ``batches`` (padded prompts [B, T], lengths [B],
    served tokens [B, S + 1], max_len); per variant (TF32 in the fp32
    matmuls or not), per batch, S + 1 logits [B, V] (fp32)."""
    qz = Quant(quant, embed.device)
    rows = {v: [_Rows(_Seq(embed, tok, lens, served[:, :-1], max_len))
                for tok, lens, served, max_len in batches] for v in variants}
    for i in range(m["num_hidden_layers"]):
        W = layer_weights(i)
        dq = _dequantized(W, qz)
        for v in variants:
            for rs in rows[v]:
                _layer(m, i, rs, W, dq, qz, v)
        del W, dq
    head_f32 = (embed if head is None else head).to(torch.float32)
    return {v: [_logits(m, rs.seq, final_norm, head_f32, v) for rs in rows[v]]
            for v in variants}
