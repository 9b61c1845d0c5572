#!/usr/bin/env python3
"""Drive the PyTorch port (``qutlass_tpu_torch``) on one CUDA card.

Phases, in order; any failure exits non-zero before the result lines:

  0. the card (nvidia-smi name and power limit), torch and CUDA versions
  1. build the four Hopper kernels from ``qutlass_tpu_torch/csrc``
  2. hold each kernel against its plain PyTorch version at the main
     path's shapes and time both (CUDA events after warm-up)
  3. the ``gpu``-marked tests, ``tests/test_torch_gpu.py``
  4. serve four ragged requests at Qwen3-8B width (seeded random
     weights, quantized on the card): 32 greedy tokens with the weights
     stored as int8 (the default), checked against a step-by-step
     replay, then the same requests with the weights stored as packed
     fp4; the kernels' launch counters are reset before and read after

Then one JSON line of per-kernel results and, last, the result line.

Usage: python3 chip_smoke.py [--layers N]
(``--layers`` cuts depth only; the default is the model's 36 layers.)
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPES_M = (4, 512)
SHAPES_KN = ((4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096))
TIMED = (512, 4096, 12288)          # (M, K, N) whose times go to the JSON line
CODE_BUDGET = 1e-4
STEPS = 32                          # greedy tokens per request
KERNELS = {
    "quantize_mx": ("qutlass_tpu_torch/csrc/quantize_mx.cu",
                    "qutlass_tpu/kernels/quantize.py:158"),
    "quantize_mx_int8": ("qutlass_tpu_torch/csrc/quantize_mx_int8.cu",
                         "qutlass_tpu/kernels/quantize.py:625"),
    "gemm_int8_rank1": ("qutlass_tpu_torch/csrc/gemm_int8_rank1.cu",
                        "qutlass_tpu/ops/int8path.py:148"),
    "gemm_fp4_mx": ("qutlass_tpu_torch/csrc/gemm_fp4_mx.cu",
                    "qutlass_tpu/kernels/gemm.py:168"),
}


class SmokeFailure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def timed_ms(torch, fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` in ms: CUDA events around ``iters``
    calls after three warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def compare_kernels(torch, results: dict) -> None:
    import qutlass_tpu_torch as qt
    from qutlass_tpu_torch.kernels import gemm as G
    from qutlass_tpu_torch.kernels import quantize as Q
    from qutlass_tpu_torch.ops import emulation as E
    from qutlass_tpu_torch.ops import int8path as I8

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    h = qt.hadamard_matrix(32, device=dev)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    def record(name, shape, err, ms=None, plain_ms=None, extra=""):
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if shape[:2] == TIMED[:2] and shape[2] in (None, TIMED[2]) and ms is not None:
            r["ms"], r["plain_ms"] = ms, plain_ms
        times = "" if ms is None else f" ms={ms:.4f} plain_ms={plain_ms:.4f}"
        print(f"phase 2 {name} M,K,N={shape} max_abs_err={err}{times}{extra}")

    def dq_rows(codes_rk, scales_gr):        # codes [rows, K], scales [K/32, rows]
        return E.dequant_fp4(codes_rk, scales_gr.T).float()

    def check_quantize(x, layout, shape, time_it):
        got = Q.quantize_mx(x, h, rot_size=32, layout=layout)
        want = Q.quantize_mx_plain(x, h, rot_size=32, layout=layout)
        require(torch.equal(got[1], want[1]), f"K1 scale bytes differ at {shape} {layout}")
        unpack = (lambda q: E.unpack_codes(q.T)) if layout == "kmajor" else E.unpack_codes
        cg, cw = unpack(got[0]), unpack(want[0])
        rate = (cg != cw).float().mean().item()
        require(rate <= CODE_BUDGET, f"K1 code mismatch {rate} at {shape} {layout}")
        s = got[1] if layout == "kmajor" else got[1][:x.shape[0], :x.shape[1] // 32].T
        err = (dq_rows(cg, s) - dq_rows(cw, s)).abs().max().item()
        ms = plain = None
        if time_it:
            ms = timed_ms(torch, lambda: Q.quantize_mx(x, h, rot_size=32, layout=layout))
            plain = timed_ms(torch, lambda: Q.quantize_mx_plain(x, h, rot_size=32,
                                                               layout=layout))
        record("quantize_mx", shape, err, ms, plain, f" layout={layout} code_mismatch={rate}")
        return got

    # activations [M, K] for both quantizers
    acts = {}
    for m in SHAPES_M:
        for k in sorted({k for k, _ in SHAPES_KN}):
            x = randn(m, k)
            shape = (m, k, None)
            check_quantize(x, "kmajor", shape, True)
            ga, gs, gb = Q.quantize_mx_int8(x, h, rot_size=32)
            wa, ws, wb = Q.quantize_mx_int8_plain(x, h, rot_size=32)
            require(torch.equal(gb, wb) and torch.equal(gs, ws),
                    f"K2 scale bytes or row scales differ at {shape}")
            rate = (ga != wa).float().mean().item()
            require(rate <= CODE_BUDGET, f"K2 a' mismatch {rate} at {shape}")
            err = ((ga.float() - wa.float()) * gs[None, :]).abs().max().item()
            ms = timed_ms(torch, lambda: Q.quantize_mx_int8(x, h, rot_size=32))
            plain = timed_ms(torch, lambda: Q.quantize_mx_int8_plain(x, h, rot_size=32))
            record("quantize_mx_int8", shape, err, ms, plain, f" a_mismatch={rate}")
            acts[m, k] = (x, ga, gs)

    for k, n in SHAPES_KN:
        w = randn(n, k, scale=k ** -0.5)
        wqt, wst = check_quantize(w, "kmajor", (None, k, n), False)
        wi, sb, dw = I8.prepare_weight_int8(wqt, wst)
        for m in SHAPES_M:
            shape = (m, k, n)
            x, ai, sa = acts[m, k]
            # K3: the main path's GEMM
            y3 = I8.matmul_mxf4_bf16_int8_kmajor(ai, wi, sa, sb, 1.0)
            want = G.gemm_int8_rank1_plain(ai.T, wi, sa, sb, 1.0)
            require(torch.equal(y3, want), f"K3 differs from its plain version at {shape}")
            ms = timed_ms(torch, lambda: I8.matmul_mxf4_bf16_int8_kmajor(ai, wi, sa, sb, 1.0))
            plain = timed_ms(torch, lambda: G.gemm_int8_rank1_plain(ai.T, wi, sa, sb, 1.0))
            bf16 = timed_ms(torch, lambda: x @ w.T)
            record("gemm_int8_rank1", shape, 0.0, ms, plain,     # bitwise, required above
                   f" torch_bf16_matmul_ms={bf16:.4f}")
            # K4: the fp4-weight GEMM, bitwise vs plain and vs K3 at deficit <= 3
            xqt, xst = Q.quantize_mx(x, h, rot_size=32, layout="kmajor")
            y4 = G.gemm_fp4_mx(xqt, wqt, xst, wst, 1.0, layout="kmajor")
            want4 = G.gemm_fp4_mx_plain(xqt, wqt, xst, wst, 1.0, layout="kmajor")
            require(torch.equal(y4, want4), f"K4 differs from its plain version at {shape}")
            ai2, sa2, da = I8.encode_int8(xqt, xst, kmajor=True)
            same = "n/a (deficit > 3)"
            if max(int(da), int(dw)) <= 3:
                y3b = I8.matmul_mxf4_bf16_int8_kmajor(ai2, wi, sa2, sb, 1.0)
                require(torch.equal(y3b, y4), f"K4 differs from K3 at deficit <= 3, {shape}")
                same = "bitwise"
            ms = timed_ms(torch, lambda: G.gemm_fp4_mx(xqt, wqt, xst, wst, 1.0,
                                                       layout="kmajor"))
            plain = timed_ms(torch, lambda: G.gemm_fp4_mx_plain(xqt, wqt, xst, wst, 1.0,
                                                                layout="kmajor"))
            record("gemm_fp4_mx", shape, 0.0, ms, plain, f" vs_K3={same}")
    # the reference-parity drive: row-major quantize + matmul_mxf4_bf16_tn
    m, k, n = 512, 4096, 4096
    xq, xs = check_quantize(randn(m, k), "rowmajor", (m, k, None), False)
    wq, ws = Q.quantize_mx(randn(n, k, scale=k ** -0.5), h, rot_size=32)
    y = qt.matmul_mxf4_bf16_tn(xq, wq, qt.to_blocked(xs), qt.to_blocked(ws), 1.0)
    want = G.gemm_fp4_mx_plain(xq, wq, xs[:m, :k // 32], ws[:n, :k // 32], 1.0, layout="tn")
    require(torch.equal(y, want), "K4 tn layout differs from its plain version")
    record("gemm_fp4_mx", (m, k, n), 0.0, extra=" layout=tn")


# ---------------------------------------------------------------------------
# phase 4: serve at Qwen3-8B width
# ---------------------------------------------------------------------------

def serve(torch, layers: int, steps: int) -> dict:
    import qutlass_tpu_torch as qt
    from qutlass_tpu_torch import models as M
    from qutlass_tpu_torch.models.transformer import PROJECTIONS
    from qutlass_tpu_torch.ops import dispatch

    cfg = dataclasses.replace(M.QWEN3_8B, num_layers=layers)
    if layers != M.QWEN3_8B.num_layers:
        print(f"phase 4 depth cut: {layers} of {M.QWEN3_8B.num_layers} layers")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    h = qt.hadamard_matrix(32, device=dev)
    lens = [128, 96, 64, 17]
    t = max(lens)
    lengths = torch.tensor(lens, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (len(lens), t), generator=gen, device=dev)
    prompt = prompt.masked_fill(torch.arange(t, device=dev)[None] >= lengths[:, None], 0)
    max_len = t + steps

    def sync_ms(t0):
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    dispatch.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, gen)
    w_int8 = M.quantize_model_weights(cfg, params, h)
    w_fp4 = M.quantize_model_weights(cfg, params, h, weight_format="fp4")
    del params
    load_ms = sync_ms(t0)
    fallback = sum("wqt" in layer[n] for layer in w_int8["layers"] for n in PROJECTIONS)
    print(f"phase 4 weights: {7 * layers} projections quantized twice in {load_ms:.0f} ms; "
          f"int8 storage keeps {fallback} as fp4 (deficit > 3)")

    run = dict(quantized=True, lengths=lengths)
    M.generate(cfg, w_int8, prompt, h, steps=2, max_len=max_len, **run)   # warm-up
    t0 = time.perf_counter()
    logits, _ = M.prefill(cfg, w_int8, prompt, h, max_len=max_len, **run)
    prefill_ms = sync_ms(t0)
    t0 = time.perf_counter()
    toks, lps = M.generate(cfg, w_int8, prompt, h, steps=steps, max_len=max_len,
                           return_logprobs=True, **run)
    generate_ms = sync_ms(t0)
    require(tuple(toks.shape) == (len(lens), steps), f"tokens shape {tuple(toks.shape)}")
    require(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "token out of range")
    require(bool(torch.isfinite(logits).all()) and bool(torch.isfinite(lps).all()),
            "non-finite logits or logprobs")
    # the served tokens equal a step-by-step replay of prefill + decode
    lg, cache = M.prefill(cfg, w_int8, prompt, h, max_len=max_len, **run)
    require(torch.equal(lg, logits), "prefill is not deterministic")
    tok, replay, pos = lg.argmax(-1), [], lengths.clone()
    t0 = time.perf_counter()
    for _ in range(steps):
        replay.append(tok)
        lg, cache = M.decode_step(cfg, w_int8, cache, tok, pos, h, quantized=True)
        tok, pos = lg.argmax(-1), pos + 1
    ms_per_token = sync_ms(t0) / steps
    require(torch.equal(torch.stack(replay, 1), toks), "generate differs from the replay")
    del cache
    # the same requests with fp4-stored weights (kernels K1 + K4)
    logits4, _ = M.prefill(cfg, w_fp4, prompt, h, max_len=max_len, **run)
    toks4 = M.generate(cfg, w_fp4, prompt, h, steps=steps, max_len=max_len, **run)
    torch.cuda.synchronize()
    counts = dict(dispatch.launch_counts)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    a, b = logits.float().ravel(), logits4.float().ravel()
    cos = float(a @ b / (a.norm() * b.norm()))
    require(bool(torch.isfinite(logits4).all()), "non-finite fp4 logits")
    # per linear the two storages agree bitwise wherever the activation
    # row's deficit is <= 3; rows beyond it round in the int8 evaluator,
    # and 36 random-weight W4A4 layers amplify that (0.958 measured on the
    # H100), so this bounds gross faults only
    require(cos > 0.9, f"fp4-stored vs int8-stored prefill logits cosine {cos}")
    agree = float((toks4 == toks).float().mean())
    print(f"phase 4 int8 weights: prefill {prefill_ms:.1f} ms for {sum(lens)} prompt tokens "
          f"(4 ragged requests, lengths {lens}), decode {ms_per_token:.2f} ms/step "
          f"(batch 4, {steps} steps), generate {generate_ms:.1f} ms; host clock "
          f"after a warm-up")
    print(f"phase 4 fp4 weights: prefill logits cosine to int8 weights {cos:.6f}, "
          f"token agreement {agree:.3f}")
    print(f"phase 4 peak device memory {peak_gib:.2f} GiB; launch counts {counts}")
    for name, c in counts.items():
        require(c > 0, f"kernel {name} was not launched by the main path")
    print(f"phase 4 first request's tokens: {toks[0, :16].tolist()}")
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=36)
    args = ap.parse_args()
    if not (ROOT / "qutlass_tpu_torch" / "csrc").is_dir():
        raise SmokeFailure("qutlass_tpu_torch/ not found beside chip_smoke.py")
    sys.path.insert(0, str(ROOT))
    import torch

    # phase 0
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    require(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0])
    print(f"phase 0 python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 1
    from qutlass_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"phase 1 built {lib.name} in {time.perf_counter() - t0:.1f} s")

    # phase 2
    results = {name: {"name": name, "route": "cuda", "source": src, "replaces": rep,
                      "launches": 0, "max_abs_err": 0.0, "ms": None, "plain_ms": None}
               for name, (src, rep) in KERNELS.items()}
    compare_kernels(torch, results)

    # phase 3
    t0 = time.perf_counter()
    test = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-q",
                           "-p", "no:cacheprovider", "-W",
                           "ignore::pytest.PytestUnknownMarkWarning",
                           "tests/test_torch_gpu.py"], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    tail = test.stdout.strip().splitlines()[-1:] or [""]
    print(f"phase 3 gpu tests ({time.perf_counter() - t0:.0f} s): {tail[0]}")
    require(test.returncode == 0, f"gpu tests failed:\n{test.stdout[-6000:]}\n{test.stderr[-2000:]}")

    # phase 4
    counts = serve(torch, args.layers, STEPS)
    for name, c in counts.items():
        results[name]["launches"] = c

    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
