"""Decoder-only transformer family (Qwen3 / Llama-3.1 geometries) with
MXFP4 or NVFP4 W4A4 quantized linear layers (counterpart of
``qutlass_tpu.models.transformer``, dense serving routes), and LFM2-MoE's
hybrid (``LFM2_24B_A2B``): gated short-conv layers (``models/shortconv.py``)
beside attention layers, a dropless sigmoid-routed expert layer
(``models/experts.py``) after the leading dense ones.  A layer's dict names
its parts: ``in_proj`` a short-conv mixer, else attention; ``router`` an
expert layer, else the dense SwiGLU MLP.  Each mixer reads and writes its
layer's own state in a cache (``init_cache``), so :func:`forward` and the
serving harness's prefill and decode step (``models/serving.py``) run one
layer, :func:`_layer`.

Parameters are a dict mirroring the JAX pytree (HF-style names), so
weights convert one to one (``models/convert.py``).  Quantized
projections are the stored dicts of :func:`quantize_weight`; each
projection runs the path its stored leaves name (``nn.linear``:
``mx_linear``, or ``nv_linear`` for NVFP4 weights, which carry ``gs``).
PyTorch runs eagerly and does not re-fuse reductions, so the JAX
package's fusion pins have no counterpart here, nor does its
``QUTLASS_TPU_NV_GSX=bound`` switch (off by default there): the NV
activation global scale is the exact rotated amax or a calibrated one.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import utils
from ..nn import linear as _lin
from ..nn.linear import linear as _linear
from ..nn.linear import quantize_weight
from ..ops.dispatch import span
from . import experts as _experts
from .shortconv import CONV_WIDTH, short_conv

# The attention einsums and rotations are fp32 reference math: no TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PROJECTIONS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
               "up_proj", "down_proj")
CONV_PROJECTIONS = ("in_proj", "out_proj")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 151_936
    hidden_size: int = 4096
    intermediate_size: int = 12_288
    num_layers: int = 36
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-6
    qk_norm: bool = True           # Qwen3 style; False for Llama
    tie_embeddings: bool = False
    # each query attends only the last ``sliding_window`` positions
    sliding_window: int | None = None
    # each layer's mixer, "attention" or "conv" (None: every layer attention)
    layer_types: tuple[str, ...] | None = None
    # experts on the layers from ``num_dense_layers`` on (0: every layer
    # dense), routed as LFM2-MoE routes them (``models/experts.py``)
    num_experts: int = 0
    experts_per_token: int = 0
    expert_width: int = 0
    num_dense_layers: int = 0

    def mixer(self, i: int) -> str:
        return "attention" if self.layer_types is None else self.layer_types[i]

    def has_experts(self, i: int) -> bool:
        return self.num_experts > 0 and i >= self.num_dense_layers


QWEN3_8B = ModelConfig()
QWEN3_14B = ModelConfig(hidden_size=5120, intermediate_size=17_408,
                        num_layers=40, num_heads=40)
QWEN3_32B = ModelConfig(hidden_size=5120, intermediate_size=25_600,
                        num_layers=64, num_heads=64)
LLAMA31_8B = ModelConfig(vocab_size=128_256, hidden_size=4096,
                         intermediate_size=14_336, num_layers=32,
                         num_heads=32, num_kv_heads=8, head_dim=128,
                         rope_theta=500_000.0, qk_norm=False)
LLAMA31_70B = ModelConfig(vocab_size=128_256, hidden_size=8192,
                          intermediate_size=28_672, num_layers=80,
                          num_heads=64, num_kv_heads=8, head_dim=128,
                          rope_theta=500_000.0, qk_norm=False)
# LiquidAI/LFM2-24B-A2B (model_type lfm2_moe): attention at layers 2, 6, ..,
# 38, short conv elsewhere; 2 dense layers, then 64 experts, top 4; tied head
LFM2_24B_A2B = ModelConfig(vocab_size=65_536, hidden_size=2048, intermediate_size=11_776,
                           num_layers=40, num_heads=32, num_kv_heads=8, head_dim=64,
                           rope_theta=1_000_000.0, rms_eps=1e-5, qk_norm=True,
                           tie_embeddings=True,
                           layer_types=tuple("attention" if i % 4 == 2 else "conv"
                                             for i in range(40)),
                           num_experts=64, experts_per_token=4, expert_width=1536,
                           num_dense_layers=2)


def tiny_config(**kw) -> ModelConfig:
    """Small config for tests / dry runs."""
    base = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                qk_norm=True)
    base.update(kw)
    return ModelConfig(**base)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device=None, dtype=torch.bfloat16) -> dict:
    """Random-initialized parameter dict (HF-style naming), drawn from
    ``generator`` on ``device`` (the card unless the caller names
    another).  The generator must live on that device."""
    device = utils.resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device} cannot draw the "
                         f"parameters on {device}: pass device= or a "
                         f"generator on {device}")

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (x * std).to(dtype)

    def dense(out_dim, in_dim):
        return normal((out_dim, in_dim), in_dim ** -0.5)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=device)

    d = cfg.hidden_size
    qd = cfg.num_heads * cfg.head_dim
    kvd = cfg.num_kv_heads * cfg.head_dim
    layers = []
    for i in range(cfg.num_layers):
        layer = {"input_norm": ones(d), "post_attn_norm": ones(d)}
        if cfg.mixer(i) == "conv":
            layer.update(in_proj=dense(3 * d, d), out_proj=dense(d, d),
                         conv=normal((d, CONV_WIDTH), CONV_WIDTH ** -0.5))
        else:
            layer.update(q_proj=dense(qd, d), k_proj=dense(kvd, d), v_proj=dense(kvd, d),
                         o_proj=dense(d, qd))
        if cfg.has_experts(i):
            e, f = cfg.num_experts, cfg.expert_width
            layer["router"] = dense(e, d)
            layer["expert_bias"] = normal((e,), 0.05).to(torch.float32)
            layer["experts"] = {"gate_proj": normal((e, f, d), d ** -0.5),
                                "up_proj": normal((e, f, d), d ** -0.5),
                                "down_proj": normal((e, d, f), f ** -0.5)}
        else:
            layer.update(gate_proj=dense(cfg.intermediate_size, d),
                         up_proj=dense(cfg.intermediate_size, d),
                         down_proj=dense(d, cfg.intermediate_size))
        if cfg.qk_norm and cfg.mixer(i) == "attention":
            layer["q_norm"] = ones(cfg.head_dim)
            layer["k_norm"] = ones(cfg.head_dim)
        layers.append(layer)
    params = {"embed": normal((cfg.vocab_size, cfg.hidden_size), 0.02),
              "final_norm": ones(cfg.hidden_size), "layers": layers}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(cfg.vocab_size, cfg.hidden_size)
    return params


def quantize_model_weights(cfg: ModelConfig, params: dict, h: torch.Tensor,
                           method: str = "quest", fmt: str = "mx",
                           weight_format: str = "int8") -> dict:
    """Pre-quantize every linear weight to MXFP4 (``fmt="mx"``) or to the
    two-level NVFP4 scheme (``fmt="nv"``, a global scale per weight);
    see :func:`quantize_weight` for ``weight_format``.  The lm head, the
    router, the conv taps and the expert bias stay as they are.  Expert
    weights are stacked packed fp4 whatever ``weight_format`` says, MXFP4
    only (``experts.quantize_stacked``).  Returns a new dict; the bf16
    weights of ``params`` are not kept by it."""
    del cfg
    out = dict(params)
    out["layers"] = []
    for layer in params["layers"]:
        ql = dict(layer)
        for name in PROJECTIONS + CONV_PROJECTIONS:
            if name in layer:
                ql[name] = quantize_weight(layer[name], h=h, method=method, fmt=fmt,
                                           weight_format=weight_format)
        if "experts" in layer:
            if fmt != "mx":
                raise ValueError(f"the expert kernel takes MXFP4 weights, not fmt={fmt!r}")
            ql["experts"] = {n: _experts.quantize_stacked(w, h, method)
                             for n, w in layer["experts"].items()}
        out["layers"].append(ql)
    return out


def calibrate_nv_gsx(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                     h: torch.Tensor, *, margin: float = 1.0,
                     method: str = "quest") -> dict:
    """Calibrate static activation global scales for the NVFP4 linears.

    Runs one forward over ``tokens`` (a representative batch), records
    each NV linear's largest rotated activation amax, and stores
    ``gsx = 448*6 / (margin * amax)`` in its weight dict (leaf
    ``"gsx"``): from then on the linear skips the per-call amax pass (a
    second rotation of its activation).  ``margin`` > 1 leaves headroom
    for activations larger than the sample's; they clip at the e2m1
    grid edge.  With ``margin == 1`` and the calibration batch itself,
    the static path equals the exact path bit for bit.  Mutates
    ``params`` in place and returns it.
    """
    ids = {id(layer[name]): layer[name] for layer in params["layers"]
           for name in PROJECTIONS
           if isinstance(layer.get(name), dict) and "gs" in layer[name]
           and "gsx" not in layer[name]}
    if not ids:
        return params
    _lin._NV_CALIB = {}
    try:
        forward(cfg, params, tokens, h, quantized=True, method=method)
        calib = dict(_lin._NV_CALIB)
    finally:
        _lin._NV_CALIB = None
    for wid, amax in calib.items():
        w = ids.get(wid)
        if w is not None:
            w["gsx"] = _lin.nv_global_scale(torch.tensor(
                margin * amax, dtype=torch.float32, device=w["gs"].device))
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


@functools.lru_cache(maxsize=None)
def _rope_inv_freq(d: int, theta: float, device: torch.device) -> torch.Tensor:
    """RoPE's inverse frequencies for head size ``d``, fp32, built once per
    device and kept there: a copy from the host on every call would wait
    for the stream, and cannot be captured in a CUDA graph."""
    return torch.tensor(1.0 / (theta ** (np.arange(0, d, 2) / d)),
                        dtype=torch.float32, device=device)


@span("qt.rope")
def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over the last dim of [B, T, H, D].

    ``positions``: [T] (shared across the batch) or [B, T] (per row).
    """
    ang = positions[..., None].to(torch.float32) * _rope_inv_freq(x.shape[-1], theta, x.device)
    if positions.ndim == 1:
        ang = ang[None]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _logits(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """bf16 hidden states [..., D] -> fp32 logits [..., vocab]: the final
    norm, then the lm head in fp32 (fp32 accumulation)."""
    x = _rms_norm(x, params["final_norm"], cfg.rms_eps)
    head = params.get("lm_head", params["embed"])
    return x.to(torch.float32) @ head.to(torch.float32).T


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


def _attention(cfg: ModelConfig, layer: dict, xin: torch.Tensor, state: dict,
               start_pos, h, method: str, quantized: bool) -> torch.Tensor:
    """The attention mixer over the normed xin [B, T, D], through o_proj,
    writing the layer's keys and values into ``state`` (``init_cache``) IN
    PLACE at positions [start_pos, start_pos + T).  ``start_pos`` is an
    int, or a [B] tensor for ragged decode (then T must be 1)."""
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
        state["k"][..., start_pos:start_pos + t] = kh.permute(0, 2, 3, 1)
        state["v"][:, :, start_pos:start_pos + t] = vh.transpose(1, 2)
    else:                                  # ragged decode: one row each
        rows = torch.arange(b, device=xin.device)   # index_put_ takes one dtype: cast the rows
        state["k"][rows, :, :, start_pos] = kh[:, 0].to(torch.float32)
        state["v"][rows, :, start_pos] = vh[:, 0].to(torch.float32)
    attn = _attend(cfg, qh, state["k"], state["v"], start_pos + t)
    attn = attn.reshape(b, t, cfg.num_heads * cfg.head_dim)
    return _linear(attn, layer["o_proj"], h, method, quantized)


def _mlp(x: torch.Tensor, layer: dict, h, method, quantized) -> torch.Tensor:
    gate = _linear(x, layer["gate_proj"], h, method, quantized)
    up = _linear(x, layer["up_proj"], h, method, quantized)
    act = (torch.nn.functional.silu(gate.to(torch.float32))
           * up.to(torch.float32)).to(x.dtype)
    return _linear(act, layer["down_proj"], h, method, quantized)


def _layer(cfg: ModelConfig, layer: dict, x: torch.Tensor, state: dict, start_pos, h,
           method, quantized, lengths=None) -> torch.Tensor:
    """One layer over x [B, T, D] at positions from ``start_pos`` on:
    x + mixer(norm(x)), then + its experts or its dense MLP over the norm
    of that.  The mixer is the short conv where the layer has one (its
    ``state["conv"]``, each row's taken at ``lengths`` [B] in a ragged
    prefill), else attention (its ``state`` k and v); either writes its
    state in place."""
    xin = _rms_norm(x, layer["input_norm"], cfg.rms_eps)
    if "in_proj" in layer:
        x = x + short_conv(layer, xin, state["conv"], h, method, quantized, lengths)
    else:
        x = x + _attention(cfg, layer, xin, state, start_pos, h, method, quantized)
    xin = _rms_norm(x, layer["post_attn_norm"], cfg.rms_eps)
    if "router" in layer:
        return x + _experts.moe(cfg, layer, xin, h, method, quantized)
    return x + _mlp(xin, layer, h, method, quantized)


@torch.no_grad()
def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            h: torch.Tensor | None = None, *, quantized: bool = False,
            method: str = "quest") -> torch.Tensor:
    """Prefill forward: tokens [B, T] int -> logits [B, T, vocab] fp32, the
    layers run as a prefill runs them, over a fresh cache of T positions.
    The head runs on each position's [B, D] rows, the GEMM of a prefill's
    last position: one GEMM over all B T rows sums in another order (MKL's
    at one row), and the last position would not be prefill's logits.

    ``quantized=True`` expects params from :func:`quantize_model_weights`
    and runs every projection through its stored W4A4 path.
    """
    b, t = tokens.shape
    x = params["embed"][tokens]
    for layer, state in zip(params["layers"], init_cache(cfg, b, t, tokens.device)):
        x = _layer(cfg, layer, x, state, 0, h, method, quantized)
    return torch.stack([_logits(cfg, params, x[:, i]) for i in range(t)], dim=1)


__all__ = ["ModelConfig", "QWEN3_8B", "QWEN3_14B", "QWEN3_32B", "LLAMA31_8B",
           "LLAMA31_70B", "LFM2_24B_A2B", "tiny_config", "init_params", "quantize_weight",
           "quantize_model_weights", "calibrate_nv_gsx", "init_cache", "forward"]
