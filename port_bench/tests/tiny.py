"""Tiny cells of the benchmark's serving driver, held in memory, for CPU tests."""
import types

from port_bench.lib import harness as H

SPEC = H.load_json(H.ROOT / "BENCHMARK.json")
QWEN = {"vocab_size": 512, "hidden_size": 256, "intermediate_size": 512,
        "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
        "head_dim": 64, "hidden_act": "silu", "attention_bias": False, "rope_theta": 1e6,
        "rms_norm_eps": 1e-6, "tie_word_embeddings": False, "qk_norm": True}
QUANT = {"format": "mxfp4", "method": "quest", "rotation_size": 32, "weight_storage": "fp4"}
LIMITS = {"widest_logit_gap": 0.05, "logit_max_abs_diff": 0.05}


def serving_cell(decode_steps=6, batch=4, limits=None, name="qwen3-8b-mxfp4.chat-b4",
                 model=None):
    tr = {"driver": "serve_steps", "loop": "closed", "batch": batch,
          "decode_steps": decode_steps, "prompt": {"dist": "lognormal", "median": 12, "sigma": 0.8, "min": 3, "max": 40}, "cycle": 4,
          "repeat": 2, "trace": {"decode_steps": 2, "requests": 2}}
    config = {"reference": "qwen3_w4a4", "model": dict(QWEN, **(model or {})),
              "quantization": QUANT}
    return H.Cell.from_parts(SPEC, name, config, tr,
                             {"batches": 1, "limits": dict(LIMITS, **(limits or {}))})


def run(cell, seed=2 ** 31 + 11, seconds=0.5, trace=0):
    args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=trace)
    return H.run_cell(cell, args, 0.0, "cpu", {"platform": "cpu"})
