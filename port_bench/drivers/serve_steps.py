"""Serving driver: a closed loop over the port's ``models.prefill`` and
``models.decode_step`` on a Qwen3 configuration with W4A4 weights.

The configuration's ``model`` gives the sizes, ``qk_norm`` and
``tie_word_embeddings``; its ``quantization`` the format, the method, the
rotation size and the weight storage; its ``reference`` the module of
``port_bench/reference`` that checks the served logits.

A mix names its batch, its decode steps a request, its prompt-length
distribution and its cycle (see ``lib/traffic.py``).  Each batch is one
ragged ``prefill(lengths=...)``, then greedy decode steps; each step's
tokens are copied to the host, as a server streaming tokens does.  The
next batch starts when the last step ends.  With no decode steps, a
request is its prefill and its first token.  Every logits row the window
serves is also copied, on the device, into a buffer with one slot per
batch of the cycle, for the check after the window.

Window metrics: ``itl_ms_p95`` (gaps between a batch's successive token
deliveries), ``ttft_ms_p95`` (a request taken to its first token on the
host), ``serve_tok_s`` (prompt tokens prefilled plus tokens delivered,
over the window's seconds).  Only work finished inside the
window counts.
"""
from __future__ import annotations

import importlib
import time

import numpy as np

from port_bench import counts
from port_bench.lib import traffic as TR
from port_bench.lib import weights as WT

# the configuration's format -> the program's name for it
PROGRAM_FORMAT = {"mxfp4": "mx", "nvfp4": "nv"}


def _to_host(tok):
    """The served tokens' one copy to the host a step (waits for the step)."""
    return tok.cpu()


def _p95(values) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95)) if values else float("nan")


class Run:
    def __init__(self, cell, seed: int, device: str):
        import torch
        self.torch, self.cell, self.seed = torch, cell, seed
        self.dev = torch.device(device)
        self.model = cell.config["model"]
        self.quant = cell.config["quantization"]
        self.ref = importlib.import_module(f"port_bench.reference.{cell.config['reference']}")
        self.tr = cell.traffic
        self.steps = self.tr["decode_steps"]
        self.done = []            # completed batches: (batch index, served tokens [B, S+1] host)

    # -- set-up ---------------------------------------------------------
    def _program_config(self):
        from qutlass_tpu_torch import models as M
        m = self.model
        if m["hidden_act"] != "silu" or m["attention_bias"]:
            raise ValueError("the port's Qwen3 block has a SiLU-gated MLP and no attention bias")
        if self.tr["loop"] != "closed":
            raise ValueError(f"{__name__} runs closed loops only, not {self.tr['loop']!r}")
        return M.ModelConfig(vocab_size=m["vocab_size"], hidden_size=m["hidden_size"],
                             intermediate_size=m["intermediate_size"],
                             num_layers=m["num_hidden_layers"],
                             num_heads=m["num_attention_heads"],
                             num_kv_heads=m["num_key_value_heads"], head_dim=m["head_dim"],
                             rope_theta=m["rope_theta"], rms_eps=m["rms_norm_eps"],
                             qk_norm=m["qk_norm"], tie_embeddings=m["tie_word_embeddings"])

    def setup(self):
        torch = self.torch
        import qutlass_tpu_torch as qt
        from qutlass_tpu_torch import models as M
        self.M = M
        q = self.quant
        self.method = q["method"]
        self.cfg = self._program_config()
        self.h = qt.hadamard_matrix(q["rotation_size"], device=self.dev)
        embed, head, final_norm = WT.qwen3_embed_head(torch, self.model, self.seed, self.dev)
        layers = []
        for i in range(self.model["num_hidden_layers"]):
            one = {"layers": [WT.qwen3_layer(torch, self.model, self.seed, i, self.dev)]}
            layers += M.quantize_model_weights(self.cfg, one, self.h, method=self.method,
                                               fmt=PROGRAM_FORMAT[q["format"]],
                                               weight_format=q["weight_storage"])["layers"]
        self.params = {"embed": embed, "final_norm": final_norm, "layers": layers}
        if head is not None:
            self.params["lm_head"] = head
        self.batches = TR.request_cycle(self.tr, self.seed)
        self.prompts = [TR.prompt_ids(torch, lens, self.model["vocab_size"], self.seed,
                                      f"prompt{i}", self.dev)
                        for i, lens in enumerate(self.batches)]
        self.logits = torch.empty((len(self.batches), self.steps + 1, self.tr["batch"],
                                   self.model["vocab_size"]), dtype=torch.float32,
                                  device=self.dev)
        # warm-up: the longest and the shortest prompt shapes of the cycle,
        # each through its prefill and two decode steps
        order = sorted(range(len(self.batches)), key=lambda i: max(self.batches[i]))
        for i in dict.fromkeys([order[-1], order[0]]):
            self._serve(i, min(self.steps, 2), None)
        torch.cuda.synchronize() if self.dev.type == "cuda" else None
        self.next = 0

    # -- the loop -------------------------------------------------------
    def _prefill(self, ids, lens, max_len):
        return self.M.prefill(self.cfg, self.params, ids, self.h, max_len=max_len,
                              quantized=True, method=self.method, lengths=lens)

    def _decode(self, cache, tok, pos):
        return self.M.decode_step(self.cfg, self.params, cache, tok, pos, self.h,
                                  quantized=True, method=self.method)

    def _serve(self, i: int, steps: int, deadline, rec=None):
        """Serve batch ``i``: prefill, first tokens, ``steps`` decode steps.
        Returns the served tokens [B, steps + 1] (host) or None if the
        deadline passed first; ``rec`` collects the window's samples."""
        torch = self.torch
        ids, lens = self.prompts[i]
        n = len(self.batches[i])
        t_req = time.perf_counter()
        logits, cache = self._prefill(ids, lens, ids.shape[1] + self.steps)
        self.logits[i, 0].copy_(logits)
        tok = torch.argmax(logits, dim=-1)
        served = [_to_host(tok)]
        t_prev = time.perf_counter()
        if deadline is not None and t_prev > deadline:
            return None
        if rec is not None:
            rec["ttft"] += [t_prev - t_req] * n
            rec["prompt"] += sum(self.batches[i])
            rec["out"] += n
            rec["flops"] += sum(counts.prefill_flops(self.model, k) for k in self.batches[i])
        pos = lens.clone()
        for s in range(steps):
            t0 = time.perf_counter()
            logits, cache = self._decode(cache, tok, pos)
            t_ret = time.perf_counter()
            self.logits[i, s + 1].copy_(logits)
            tok = torch.argmax(logits, dim=-1)
            served.append(_to_host(tok))
            t = time.perf_counter()
            if deadline is not None and t > deadline:
                return None
            if rec is not None:
                rec["itl"].append(t - t_prev)
                rec["host"].append(t_ret - t0)
                rec["out"] += n
                rec["flops"] += sum(counts.decode_flops(self.model, k + s)
                                    for k in self.batches[i])
            t_prev = t
            pos = pos + 1
        return torch.stack(served, dim=1)

    def window(self, seconds: float) -> dict:
        rec = {"ttft": [], "itl": [], "host": [], "prompt": 0, "out": 0, "flops": 0}
        t0 = time.perf_counter()
        deadline = t0 + seconds
        attempted = 0
        while True:
            i = self.next
            self.next = (self.next + 1) % len(self.batches)
            attempted += len(self.batches[i])
            served = self._serve(i, self.steps, deadline, rec)
            if served is None:
                attempted -= len(self.batches[i])      # cut by the window's end, not failed
                # the cut serve wrote part of slot i: an earlier serve of i is no longer whole
                self.done = [d for d in self.done if d[0] != i]
                break
            self.done = [d for d in self.done if d[0] != i] + [(i, served)]
        if not self.done:             # finish one batch past the window, to check it
            self.done.append((i, self._serve(i, self.steps, None)))
        work = {"seconds": seconds, "flops": rec["flops"], "decode_host_s": rec["host"]}
        metrics = {"serve_tok_s": (rec["prompt"] + rec["out"]) / seconds,
                   "itl_ms_p95": _p95(rec["itl"]) * 1e3,
                   "ttft_ms_p95": _p95(rec["ttft"]) * 1e3}
        return {"metrics": metrics, "attempted": attempted, "failed": 0, "work": work}

    # -- the traced stretch ----------------------------------------------
    def traced(self):
        """Profile a bounded stretch of the same traffic: with decode
        steps, ``trace.decode_steps`` steps of a fresh batch after its
        prefill; without, ``trace.requests`` requests."""
        from torch.profiler import ProfilerActivity, profile, record_function
        from port_bench.lib import trace as T
        torch = self.torch
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.dev.type == "cuda" else [])
        if self.steps:
            n = self.tr["trace"]["decode_steps"]
            i = self.next
            ids, lens = self.prompts[i]
            logits, cache = self._prefill(ids, lens, ids.shape[1] + self.steps)
            tok, pos = torch.argmax(logits, dim=-1), lens.clone()
            _to_host(tok)
            from qutlass_tpu_torch.ops import dispatch
            launched = sum(dispatch.launch_counts.values())
            with profile(activities=acts) as prof:
                with record_function(T.STRETCH):
                    for _ in range(n):
                        with record_function("bench.decode_step"):
                            logits, cache = self._decode(cache, tok, pos)
                        tok = torch.argmax(logits, dim=-1)
                        with record_function("bench.token_copy"):
                            _to_host(tok)
                        pos = pos + 1
            work = {"format": self.quant["format"],
                    "gemms": counts.gemms_of_rows(self.model, len(self.batches[i])) * n,
                    "port_launches": sum(dispatch.launch_counts.values()) - launched}
            return T.from_profiler(prof, n, work)
        n = self.tr["trace"]["requests"]
        picks = [(self.next + j) % len(self.batches) for j in range(n)]
        with profile(activities=acts) as prof:
            with record_function(T.STRETCH):
                for i in picks:
                    ids, lens = self.prompts[i]
                    with record_function("bench.prefill"):
                        logits, _ = self._prefill(ids, lens, ids.shape[1])
                    with record_function("bench.token_copy"):
                        _to_host(torch.argmax(logits, dim=-1))
        rows = [ids.shape[0] * ids.shape[1] for ids, _ in (self.prompts[i] for i in picks)]
        prompt = sum(sum(self.batches[i]) for i in picks)
        work = {"format": self.quant["format"], "prompt_tokens": prompt,
                "gemms": [g for r in rows for g in counts.gemms_of_rows(self.model, r)]}
        return T.from_profiler(prof, n, work)

    # -- the output check -------------------------------------------------
    def release(self):
        del self.params
        if self.dev.type == "cuda":
            self.torch.cuda.empty_cache()

    def _sample(self):
        """The completed batches to check, drawn from the seed: the
        ``check.batches`` of them, the one with the longest prompt first."""
        k = self.cell.checks["batches"]
        rng = np.random.default_rng(TR.derive(self.seed, "check"))
        longest = max(range(len(self.done)), key=lambda j: max(self.batches[self.done[j][0]]))
        rest = [j for j in range(len(self.done)) if j != longest]
        rng.shuffle(rest)
        return [self.done[j] for j in [longest] + rest[:k - 1]]

    def reference_batches(self, sample):
        out = []
        for i, served in sample:
            ids, lens = self.prompts[i]
            max_len = ids.shape[1] + self.steps
            out.append((ids, lens, served.to(self.dev), max_len))
        return out

    def reference_logits(self, batches, variants=(False,)):
        """The reference's logits at every served position of ``batches``,
        its weights drawn again from the seed (``variants``: see the
        reference's ``served_logits``)."""
        torch = self.torch
        embed, head, final_norm = WT.qwen3_embed_head(torch, self.model, self.seed, self.dev)
        return self.ref.served_logits(
            self.model, self.quant,
            lambda i: WT.qwen3_layer(torch, self.model, self.seed, i, self.dev),
            embed, head, final_norm, batches, variants=variants)

    def program_logits(self, sample) -> list:
        """The program's logits at the served positions of ``sample``, as the
        reference gives its own: per batch, S + 1 rows [B, V]."""
        return [list(self.logits[i].unbind(0)) for i, _ in sample]

    def check(self):
        """Against the reference, over every served position of the sampled
        batches: the widest gap by which a served token's logit lies below
        the reference's best, and the largest difference of a logit the
        program served from the reference's."""
        sample = self._sample()
        batches = self.reference_batches(sample)
        ref = self.reference_logits(batches)[False]
        gap = max(self.ref.widest_gap(lg, b[2]) for lg, b in zip(ref, batches))
        diff = largest_diff(ref, self.program_logits(sample))
        limits = self.cell.checks["limits"]
        return [("widest_logit_gap", gap, limits["widest_logit_gap"]),
                ("logit_max_abs_diff", diff, limits["logit_max_abs_diff"])]


def largest_diff(ref: list, other: list) -> float:
    """The largest |difference| of two sets of logits, each per batch a
    list of rows [B, V] at the same served positions."""
    return max(float((a - b).abs().max()) for ra, rb in zip(ref, other) for a, b in zip(ra, rb))
