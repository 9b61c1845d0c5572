"""Serving driver for LFM2-MoE configurations: the closed loop of
``serve_steps`` (ragged ``prefill``, greedy ``decode_step`` with each
step's tokens copied to the host, the window, the check) over the port's
``models.ModelConfig`` with short-conv and attention layers and a dropless
expert layer.

The configuration holds the source's keys at its top level, as published
(``layer_types``, ``conv_L_cache``, ``num_experts``, ...), with
``assumed`` for what the source leaves out (``head_dim``,
``tie_word_embeddings``), ``quantization`` and ``reference`` as for
``serve_steps``.  Weights are drawn layer by layer from the seed, the
experts of a layer stacked, and quantized as they are drawn.  The model
FLOPs of the window count the active experts (``expert_counts``); the
traced stretch hands the readers the grouped expert GEMMs' rows and
active experts, read from the program's routing counters around it.
"""
from __future__ import annotations

import importlib
import time

from port_bench import expert_counts as EC
from port_bench.drivers import serve_steps as SS
from port_bench.drivers.serve_steps import largest_diff  # noqa: F401  (calibrate.py reads it)
from port_bench.lib import traffic as TR
from port_bench.lib import weights as WT


def lfm2_layer(torch, model: dict, seed: int, index: int, device) -> dict:
    """Layer ``index``'s weights under the port's names: its mixer's
    projections (std fan_in^-1/2) and conv taps (std W^-1/2), or q, k, v,
    o and the per-head norms; its dense MLP, or its router (std D^-1/2),
    expert bias (std 0.05, fp32) and stacked experts [E, N, K] (std
    fan_in^-1/2); norms 1."""
    d, hd = model["hidden_size"], model["assumed"]["head_dim"]
    qd, kvd = model["num_attention_heads"] * hd, model["num_key_value_heads"] * hd
    tag = f"lfm2.layer{index}"

    def draw(part, shapes, std_of=lambda n, k: k ** -0.5):
        return WT._dense_group(torch, shapes, std_of, seed, tag + part, device)

    def ones(n):
        return torch.ones((n,), dtype=torch.bfloat16, device=device)

    layer = {"input_norm": ones(d), "post_attn_norm": ones(d)}
    if model["layer_types"][index] == "conv":
        layer["in_proj"], layer["out_proj"] = draw("", [(3 * d, d), (d, d)])
        (layer["conv"],) = draw(".conv", [(d, model["conv_L_cache"])])
    else:
        layer.update(zip(("q_proj", "k_proj", "v_proj", "o_proj"),
                         draw("", [(qd, d), (kvd, d), (kvd, d), (d, qd)])))
        layer.update(q_norm=ones(hd), k_norm=ones(hd))
    if index < model["num_dense_layers"]:
        i = model["intermediate_size"]
        layer.update(zip(("gate_proj", "up_proj", "down_proj"),
                         draw(".mlp", [(i, d), (i, d), (d, i)])))
        return layer
    e = model["num_experts"]
    (layer["router"],) = draw(".router", [(e, d)])
    (bias,) = draw(".bias", [(1, e)], lambda n, k: 0.05)
    layer["expert_bias"] = bias[0].to(torch.float32)
    layer["experts"] = {}
    for name, (n, k) in zip(("gate_proj", "up_proj", "down_proj"), EC.expert_shapes(model)):
        (w,) = draw(f".{name}", [(e * n, k)])
        layer["experts"][name] = w.view(e, n, k)
    return layer


def lfm2_embed(torch, model: dict, seed: int, device):
    """(embedding [V, D] with std 0.02, also the head, final norm weight)."""
    v, d = model["vocab_size"], model["hidden_size"]
    (embed,) = WT._dense_group(torch, [(v, d)], lambda n, k: 0.02, seed, "embed", device)
    return embed, torch.ones((d,), dtype=torch.bfloat16, device=device)


class Run(SS.Run):
    def __init__(self, cell, seed: int, device: str):
        import torch
        self.torch, self.cell, self.seed = torch, cell, seed
        self.dev = torch.device(device)
        self.model = cell.config
        self.quant = cell.config["quantization"]
        self.ref = importlib.import_module(f"port_bench.reference.{cell.config['reference']}")
        self.tr = cell.traffic
        self.steps = self.tr["decode_steps"]
        self.done = []

    # -- set-up ---------------------------------------------------------
    def _program_config(self):
        from qutlass_tpu_torch import models as M
        m = self.model
        from qutlass_tpu_torch.models.shortconv import CONV_WIDTH
        if (m["model_type"] != "lfm2_moe" or m["conv_bias"] or m["conv_L_cache"] != CONV_WIDTH
                or not m["assumed"]["tie_word_embeddings"]):
            raise ValueError(f"the port's LFM2 block has a bias-free conv of {CONV_WIDTH} taps "
                             f"and a tied head")
        if (not m["use_expert_bias"] or not m["norm_topk_prob"]
                or m["routed_scaling_factor"] != 1):
            raise ValueError("the port's LFM2 experts are routed with a selection bias, "
                             "normalised top-k weights and a scale of 1")
        if self.tr["loop"] != "closed":
            raise ValueError(f"{__name__} runs closed loops only, not {self.tr['loop']!r}")
        kinds = {"conv": "conv", "full_attention": "attention"}
        return M.ModelConfig(
            vocab_size=m["vocab_size"], hidden_size=m["hidden_size"],
            intermediate_size=m["intermediate_size"], num_layers=m["num_hidden_layers"],
            num_heads=m["num_attention_heads"], num_kv_heads=m["num_key_value_heads"],
            head_dim=m["assumed"]["head_dim"], rope_theta=float(m["rope_parameters"]["rope_theta"]),
            rms_eps=m["norm_eps"], qk_norm=True, tie_embeddings=True,
            layer_types=tuple(kinds[t] for t in m["layer_types"]),
            num_experts=m["num_experts"], experts_per_token=m["num_experts_per_tok"],
            expert_width=m["moe_intermediate_size"], num_dense_layers=m["num_dense_layers"])

    def setup(self):
        torch = self.torch
        import qutlass_tpu_torch as qt
        from qutlass_tpu_torch import models as M
        from qutlass_tpu_torch.models import experts as X
        self.M = M
        q = self.quant
        self.method = q["method"]
        self.cfg = self._program_config()
        self.h = qt.hadamard_matrix(q["rotation_size"], device=self.dev)
        embed, final_norm = lfm2_embed(torch, self.model, self.seed, self.dev)
        layers = []
        for i in range(self.model["num_hidden_layers"]):
            one = {"layers": [lfm2_layer(torch, self.model, self.seed, i, self.dev)]}
            layers += M.quantize_model_weights(self.cfg, one, self.h, method=self.method,
                                               fmt=SS.PROGRAM_FORMAT[q["format"]],
                                               weight_format=q["weight_storage"])["layers"]
        self.params = {"embed": embed, "final_norm": final_norm, "layers": layers}
        X.count_routes(self.params)
        self.batches = TR.request_cycle(self.tr, self.seed)
        self.prompts = [TR.prompt_ids(torch, lens, self.model["vocab_size"], self.seed,
                                      f"prompt{i}", self.dev)
                        for i, lens in enumerate(self.batches)]
        self.logits = torch.empty((len(self.batches), self.steps + 1, self.tr["batch"],
                                   self.model["vocab_size"]), dtype=torch.float32,
                                  device=self.dev)
        order = sorted(range(len(self.batches)), key=lambda i: max(self.batches[i]))
        for i in dict.fromkeys([order[-1], order[0]]):
            self._serve(i, min(self.steps, 2), None)
        torch.cuda.synchronize() if self.dev.type == "cuda" else None
        self.next = 0

    # -- the loop: serve_steps' with this model's FLOPs --------------------
    def _serve(self, i: int, steps: int, deadline, rec=None):
        torch = self.torch
        ids, lens = self.prompts[i]
        n = len(self.batches[i])
        t_req = time.perf_counter()
        logits, cache = self._prefill(ids, lens, ids.shape[1] + self.steps)
        self.logits[i, 0].copy_(logits)
        tok = torch.argmax(logits, dim=-1)
        served = [SS._to_host(tok)]
        t_prev = time.perf_counter()
        if deadline is not None and t_prev > deadline:
            return None
        if rec is not None:
            rec["ttft"] += [t_prev - t_req] * n
            rec["prompt"] += sum(self.batches[i])
            rec["out"] += n
            rec["flops"] += sum(EC.prefill_flops(self.model, k) for k in self.batches[i])
        pos = lens.clone()
        for s in range(steps):
            t0 = time.perf_counter()
            logits, cache = self._decode(cache, tok, pos)
            t_ret = time.perf_counter()
            self.logits[i, s + 1].copy_(logits)
            tok = torch.argmax(logits, dim=-1)
            served.append(SS._to_host(tok))
            t = time.perf_counter()
            if deadline is not None and t > deadline:
                return None
            if rec is not None:
                rec["itl"].append(t - t_prev)
                rec["host"].append(t_ret - t0)
                rec["out"] += n
                rec["flops"] += sum(EC.decode_flops(self.model, k + s) for k in self.batches[i])
            t_prev = t
            pos = pos + 1
        return torch.stack(served, dim=1)

    # -- the traced stretch ----------------------------------------------
    def _routed(self):
        """The routing counters of the expert layers, on the host: per layer
        [rows routed to each expert, calls in which each was active]."""
        return [layer["route_counts"].tolist() for layer in self.params["layers"]
                if "route_counts" in layer]

    def traced(self):
        """``trace.decode_steps`` decode steps of a fresh batch after its
        prefill, profiled; the work holds each expert layer's grouped GEMMs
        over the stretch, from the routing counters' change."""
        from torch.profiler import ProfilerActivity, profile, record_function
        from port_bench.lib import trace as T
        from qutlass_tpu_torch.ops import dispatch
        torch = self.torch
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.dev.type == "cuda" else [])
        n = self.tr["trace"]["decode_steps"]
        ids, lens = self.prompts[self.next]
        logits, cache = self._prefill(ids, lens, ids.shape[1] + self.steps)
        tok, pos = torch.argmax(logits, dim=-1), lens.clone()
        SS._to_host(tok)
        launched = sum(dispatch.launch_counts.values())
        before = self._routed()
        with profile(activities=acts) as prof:
            with record_function(T.STRETCH):
                for _ in range(n):
                    with record_function("bench.decode_step"):
                        logits, cache = self._decode(cache, tok, pos)
                    tok = torch.argmax(logits, dim=-1)
                    with record_function("bench.token_copy"):
                        SS._to_host(tok)
                    pos = pos + 1
        routed = [[[a - b for a, b in zip(ra, rb)] for ra, rb in zip(la, lb)]
                  for la, lb in zip(self._routed(), before)]
        work = {"format": self.quant["format"],
                "expert_gemms": EC.expert_gemms(self.model, routed),
                "port_launches": sum(dispatch.launch_counts.values()) - launched}
        return T.from_profiler(prof, n, work)

    # -- the output check -------------------------------------------------
    def reference_logits(self, batches, variants=(False,)):
        """The reference's logits at every served position of ``batches``,
        its weights drawn again from the seed, layer by layer."""
        torch = self.torch
        embed, final_norm = lfm2_embed(torch, self.model, self.seed, self.dev)
        return self.ref.served_logits(
            self.model, self.quant, lambda i: lfm2_layer(torch, self.model, self.seed, i, self.dev),
            embed, None, final_norm, batches, variants=variants)
