"""A dropless mixture of experts with sigmoid routing (LFM2-MoE's sparse
block) on MXFP4 W4A4 expert weights:

    s = sigmoid(x Wr^T)                      router Wr [E, D] bf16, an fp32 product
    e_1 .. e_k = the top k of s + b          b: a selection-only bias (``expert_bias``)
    w_j = s[e_j] / (s[e_1] + .. + s[e_k] + 1e-6)
    y = sum_j w_j expert_{e_j}(x),   expert(x) = down(silu(gate x) * up x)

LFM2-MoE's published routing, fixed here: the chosen scores normalised,
scaled by 1, and the bias applied wherever the layer holds one.

Every token reaches its k experts: no capacity, nothing dropped.  The
router, the sigmoid, the top k and the weights are fp32 (the sums over the
k chosen in top-k order); each expert's SwiGLU is the dense MLP's
arithmetic; a token's k expert outputs are weighted and summed in fp32 in
top-k order, then rounded to bf16.

Dispatch is a counting sort with static shapes: the k assignments of each
token are ordered by expert (stably, so by token within an expert), giving
each expert a run of rows ``[offsets[e], offsets[e + 1])``.  The layer's
input rows are quantized once (K1) for every expert's gate and up
projections, the SwiGLU rows once for the down projections.  Up to
``DECODE_M`` tokens (a decode step), or while a CUDA graph is captured,
each projection is one launch of K18 (``kernels.gemm.gemm_fp4_experts``),
which reads the offsets from device memory and reads only the routed
experts' weights: no host sync.  A prefill reads the offsets on the host
once a layer and runs K4 on each routed expert's rows.

Expert weights are stacked per layer, packed fp4 (``wqt`` u8 [E, K/2, N],
``wst`` u8 [E, K/32, N]) whatever the dense projections' storage, so that
one kernel indexes them.  :func:`count_routes` gives each expert layer a
routing counter, ``route_counts`` [2, E] int64: K18's gate launch adds on
the device the rows routed to each expert (row 0) and 1 for each expert
that got a row (row 1), so it counts the calls that run K18 (decode
steps, replays included) at no launch of its own; a prefill leaves it.
"""
from __future__ import annotations

import torch

import qutlass_tpu_torch as q
from ..kernels.gemm import DECODE_M, gemm_fp4_experts
from ..nn.linear import mx_alpha
from ..ops.dispatch import span


def quantize_stacked(w: torch.Tensor, h: torch.Tensor, method: str = "quest") -> dict:
    """Stacked bf16 expert weights [E, N, K] -> the stored dict: packed
    fp4 ``wqt`` [E, K/2, N], e8m0 ``wst`` [E, K/32, N] (each expert's
    weight as ``nn.linear.quantize_weight(..., weight_format="fp4")``
    stores it: the rows quantize one by one), and an ``am`` marker for
    abs-max."""
    e, n, k = w.shape
    wqt, wst = q.fusedQuantizeMx(w.reshape(e * n, k), h, method=method, layout="kmajor")
    out = {"wqt": wqt.view(k // 2, e, n).permute(1, 0, 2).contiguous(),
           "wst": wst.view(k // 32, e, n).permute(1, 0, 2).contiguous()}
    if method == "abs_max":
        out["am"] = torch.ones((), dtype=torch.int8, device=w.device)
    return out


def route(cfg, layer: dict, x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(experts [T, k] int64 in top-k order, weights [T, k] fp32) of the
    tokens x2 [T, D]."""
    logits = x2.to(torch.float32) @ layer["router"].to(torch.float32).T
    s = torch.sigmoid(logits)
    sel = s + layer["expert_bias"] if "expert_bias" in layer else s
    idx = torch.topk(sel, cfg.experts_per_token, dim=-1).indices
    w = s.gather(1, idx)
    total = w[:, 0]
    for j in range(1, w.shape[1]):
        total = total + w[:, j]
    return idx, w / (total + 1e-6)[:, None]


def dispatch(idx: torch.Tensor, num_experts: int):
    """The counting sort of the assignments a = t k + j by expert:
    (pos [A] the sorted row of each assignment, rows [A] int32 the token
    of each sorted row, offsets [E + 1] int32)."""
    e = idx.reshape(-1)
    a = e.shape[0]
    # [E, A]: the scan runs along the inner dimension (along the outer one,
    # over a prefill's A ~ 1e5 rows, it took ~37 ms a layer on the H100)
    onehot = (torch.arange(num_experts, device=e.device)[:, None] == e).to(torch.int32)
    cum = onehot.cumsum(1)                                   # int64
    counts = cum[:, -1]
    ends = counts.cumsum(0)
    pos = (ends - counts)[e] + cum.gather(0, e[None])[0] - 1
    tokens = torch.arange(a, device=e.device, dtype=torch.int32) // idx.shape[1]
    rows = torch.empty_like(tokens).scatter_(0, pos, tokens)
    offsets = torch.cat([ends.new_zeros(1), ends]).to(torch.int32)
    return pos, rows, offsets


def count_routes(params: dict) -> None:
    """Give each expert layer of ``params`` a zeroed routing counter
    ``route_counts`` [2, E] int64 (before its first decode step: a
    captured step holds the layer dicts it saw)."""
    for layer in params["layers"]:
        if "router" in layer:
            layer["route_counts"] = torch.zeros((2, layer["router"].shape[0]),
                                                dtype=torch.int64, device=layer["router"].device)


def _per_expert(xqt, xst, w: dict, rows, offsets: list, alpha: float) -> torch.Tensor:
    """The expert GEMM of a prefill: K4 on each routed expert's rows
    (``offsets`` read on the host); ``rows`` None means row r is column r."""
    n = w["wqt"].shape[2]
    out = torch.empty((offsets[-1], n), dtype=torch.bfloat16, device=xqt.device)
    for e in range(len(offsets) - 1):
        s, t = offsets[e], offsets[e + 1]
        if t > s:
            cols = slice(s, t) if rows is None else rows[s:t].long()
            out[s:t] = q.matmul_mxf4_bf16_kmajor(xqt[:, cols], w["wqt"][e], xst[:, cols],
                                                 w["wst"][e], alpha)
    return out


@span("qt.moe")
def moe(cfg, layer: dict, x: torch.Tensor, h: torch.Tensor, method: str,
        quantized: bool) -> torch.Tensor:
    """The expert layer over x [..., D] (bf16, normed) -> [..., D] bf16:
    router, dispatch, the experts' SwiGLU, combine."""
    if not quantized:
        raise ValueError("the expert layer runs W4A4 only: pass quantized=True with "
                         "weights from quantize_model_weights")
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    t = x2.shape[0]
    idx, w = route(cfg, layer, x2)
    pos, rows, offsets = dispatch(idx, cfg.num_experts)
    ex = layer["experts"]
    xqt, xst = q.fusedQuantizeMx(x2, h, method=method, layout="kmajor")
    if t <= DECODE_M or (x.is_cuda and torch.cuda.is_current_stream_capturing()):
        def gemm(aq, asf, wt, r, counts=None):
            return gemm_fp4_experts(aq, asf, wt["wqt"], wt["wst"], offsets, mx_alpha(wt, method),
                                    rows=r, max_rows=t, counts=counts)
    else:
        host = offsets.tolist()                       # the one host read of a prefill layer

        def gemm(aq, asf, wt, r, counts=None):        # a prefill leaves the counter
            return _per_expert(aq, asf, wt, r, host, mx_alpha(wt, method))
    gate = gemm(xqt, xst, ex["gate_proj"], rows, layer.get("route_counts"))
    up = gemm(xqt, xst, ex["up_proj"], rows)
    act = (torch.nn.functional.silu(gate.to(torch.float32))
           * up.to(torch.float32)).to(torch.bfloat16)
    aqt, ast = q.fusedQuantizeMx(act, h, method=method, layout="kmajor")
    y = gemm(aqt, ast, ex["down_proj"], None).index_select(0, pos)
    y = y.view(t, idx.shape[1], d).to(torch.float32)
    acc = y[:, 0] * w[:, 0:1]
    for j in range(1, idx.shape[1]):
        acc = acc + y[:, j] * w[:, j:j + 1]
    return acc.to(torch.bfloat16).reshape(x.shape)
