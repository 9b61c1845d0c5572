#!/usr/bin/env python3
"""Drive the PyTorch port (``qutlass_tpu_torch``) on one CUDA card.

Phases, in order; any failure exits non-zero before the result lines:

  0. the card (nvidia-smi name and power limit), torch and CUDA versions
  1. build the eighteen Hopper kernels from ``qutlass_tpu_torch/csrc``
  2. hold each kernel against its plain PyTorch version at the main
     paths' shapes and time both (CUDA events after warm-up), beside
     the card's bound for the same work and, where one PyTorch call
     computes the same function, that call's time; K3 in every operand
     order at the decode, prefill and QAT shapes, in bf16 and fp32,
     against its targets (bf16 ``torch.matmul`` at M <= 16,
     ``torch._int_mm`` above) and summed over a decode step, a prefill
     and a QAT step; K2 and K6 summed over an int8 decode step and a
     prefill, beside the time of one launch on this card; K4 and K7
     (bitwise, bf16 and fp32, at M = 4 through their split-K decode
     kernel, at M = 512 through their prefill kernel, one template of
     both formats, and K7 at M = 64; K4 also in the tn and kmajor_codes
     layouts) summed over an fp4 decode step and a prefill, beside the
     step's weight byte bound, launch floor and (prefill) fp64 fold
     floor; K4's warp-specialised prefill kernel, which is not in the
     library and which no call runs (built on demand by
     ``tools/time_mx_prefill_wg.py``), bitwise K4 and timed against it in
     turns at (512, 4096, 12288) and at the ``long-prompt`` cell's prompt
     lengths M = 345, 1596 and 6523 on Qwen3-8B's four (K, N); the QAT
     kernels
     (K8-K11, K3 in the int8 backward's orders, and the training
     forward's K1 with the clip mask and K3) at the training shapes of
     phase 6, the backward-operand kernels K12-K15 at phase 7's, and the
     single-kernel linears K16 / K17 at decode, small-prefill and
     prefill sizes of Qwen3-8B's MLP, also bitwise against the
     composition they replace (K1 + K4, K5 + K7); the grouped expert GEMM
     K18 at LFM2-24B-A2B's decode shapes (8 tokens, top 4 of 64 experts;
     gate / up and down), bitwise, its routing counter against the
     routing, timed beside the bound of reading each routed expert once
  3. the ``gpu``-marked tests, ``tests/test_torch_gpu.py``,
     ``tests/test_torch_decode_graph.py``, ``tests/test_torch_lfm2_moe.py``
     and ``tests/test_torch_kv_cache.py``
  4. MXFP4 serving: four ragged requests at Qwen3-8B width (seeded
     random weights, quantized on the card), 32 greedy tokens with the
     weights stored as int8 (the default), checked against a
     step-by-step replay, then the same requests with the weights
     stored as packed fp4 (K4's decode kernel at every decode step, its
     prefill kernel at the prefill), timed and checked against a replay
  5. NVFP4 serving, the same requests: int8-stored weights with the
     exact per-call activation scale, then with calibrated static
     scales, then fp4-stored weights (K7's decode kernel at every decode
     step, its prefill kernel at the prefill), each timed and checked
     against a step-by-step replay
  6. Quartet QAT training at Qwen3-8B MLP width: the QAT example's MLP
     (4096 -> 12288 -> 4096, ``QuartetLinear``) on 4096-token batches,
     10 Adam steps in each grad mode with falling loss, gradient
     cosines against the exact STE, and the reference's byte-level
     MXFP8 backward flow (K9, K10, K11) held against the mxfp8 mode
  7. the Quartet backward-operand ops on layer 1 of phase 6's MLP (x
     [4096, 4096], W1 [12288, 4096], dY [4096, 12288]): the natural-order
     golden of the bf16 grad mode through K15, the reference backward
     flow of ``qutlass_tpu/nn/linear.py`` through K8 and K14 against
     phase 6's byte-level flow, and SURVEY.md 3.4's wgrad operands
     through K12, K13 and the fp4 GEMM K4
  8. the single-kernel quantized linear at Qwen3-8B MLP width: phase 6's
     trained MLP in eval mode on 4, 64 and 4096 tokens, and an abs-max
     layer, through ``fused_linear_mxf4`` with ``QUTLASS_TPU_FUSED_LINEAR``
     unset (K1 + K4) and set (K16), bitwise equal; Qwen3-8B's gate and
     down projections on NVFP4 weights through ``fused_linear_nvf4`` (K5 +
     K7 against K17) on 4 and 64 tokens
  9. LFM2-24B-A2B serving at its published widths, its first six layers
     (short conv, attention, dense and expert layers): eight ragged
     prompts, 16 decode steps through the decode graph with the routing
     counters on, K18's launches (3 an expert layer a step) and the
     counters against the routing, the replayed steps' logits bitwise
     the eager body's

Phases 4 to 9 each reset the kernels' launch counters just before they
drive their path (phase 8: each route's run) and read them just after.
Then one JSON line of per-kernel results and, last, the result line.

Usage: python3 chip_smoke.py [--layers N] [--qat-lr LR]
(``--layers`` cuts phases 4 and 5's serving depth only; the default is the
model's 36 layers.  ``--qat-lr`` sets phase 6's Adam learning rate.)
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPES_M = (4, 512)
SHAPES_KN = ((4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096))
TIMED = (512, 4096, 12288)          # (M, K, N) whose times go to the JSON line
K7_SMALL_M = 64                     # phase 8's small prefill, K7 checked there too
CODE_BUDGET = 1e-4
STEPS = 32                          # greedy tokens per request
LENS = [128, 96, 64, 17]            # the ragged requests' prompt lengths
KERNELS = {      # name: (source, the pl.pallas_call of the TPU kernel it replaces)
    "quantize_mx": ("qutlass_tpu_torch/csrc/quantize_mx.cu",
                    "qutlass_tpu/kernels/quantize.py:203"),
    "quantize_mx_int8": ("qutlass_tpu_torch/csrc/quantize_mx_int8.cu",
                         "qutlass_tpu/kernels/quantize.py:648"),
    "gemm_int8_rank1": ("qutlass_tpu_torch/csrc/gemm_int8_rank1.cu",
                        "qutlass_tpu/ops/int8path.py:148"),
    "gemm_fp4_mx": ("qutlass_tpu_torch/csrc/gemm_fp4_mx.cu",
                    "qutlass_tpu/kernels/gemm.py:193"),
    "gemm_fp4_mx_decode": ("qutlass_tpu_torch/csrc/gemm_fp4_decode.cuh",
                           "qutlass_tpu/kernels/gemm.py:193"),
    "gemm_fp4_mx_prefill": ("qutlass_tpu_torch/csrc/gemm_fp4_prefill.cuh",
                            "qutlass_tpu/kernels/gemm.py:193"),
    "quantize_nv": ("qutlass_tpu_torch/csrc/quantize_nv.cu",
                    "qutlass_tpu/kernels/quantize.py:248"),
    "quantize_nv_int8": ("qutlass_tpu_torch/csrc/quantize_nv_int8.cu",
                         "qutlass_tpu/kernels/quantize.py:719"),
    "gemm_fp4_nv": ("qutlass_tpu_torch/csrc/gemm_fp4_nv.cu",
                    "qutlass_tpu/kernels/gemm.py:193"),
    "gemm_fp4_nv_decode": ("qutlass_tpu_torch/csrc/gemm_fp4_decode.cuh",
                           "qutlass_tpu/kernels/gemm.py:193"),
    "gemm_fp4_nv_prefill": ("qutlass_tpu_torch/csrc/gemm_fp4_prefill.cuh",
                            "qutlass_tpu/kernels/gemm.py:193"),
    "square_double_scaled": ("qutlass_tpu_torch/csrc/square_double.cu",
                             "qutlass_tpu/kernels/backward.py:324"),
    "square_double_mxfp8": ("qutlass_tpu_torch/csrc/square_double.cu",
                            "qutlass_tpu/kernels/backward.py:254"),
    "mxfp4_transpose_mxfp8": ("qutlass_tpu_torch/csrc/transpose_mxfp8.cu",
                              "qutlass_tpu/kernels/backward.py:495"),
    "gemm_fp8_mx": ("qutlass_tpu_torch/csrc/gemm_fp8_mx.cu",
                    "qutlass_tpu/kernels/gemm.py:193"),
    "backward_t_bf16": ("qutlass_tpu_torch/csrc/backward_quant.cu",
                        "qutlass_tpu/kernels/backward.py:95"),
    "backward_qt_bf16": ("qutlass_tpu_torch/csrc/backward_quant.cu",
                         "qutlass_tpu/kernels/backward.py:173"),
    "mxfp4_transpose_scaled": ("qutlass_tpu_torch/csrc/transpose_mxfp8.cu",
                               "qutlass_tpu/kernels/backward.py:403"),
    "mxfp4_transpose_scaled_kmajor": ("qutlass_tpu_torch/csrc/transpose_mxfp8.cu",
                                      "qutlass_tpu/kernels/backward.py:461"),
    "fused_linear_mx": ("qutlass_tpu_torch/csrc/fused_linear.cu",
                        "qutlass_tpu/kernels/fused_linear.py:144"),
    "fused_linear_nv": ("qutlass_tpu_torch/csrc/fused_linear.cu",
                        "qutlass_tpu/kernels/fused_linear.py:144"),
    # the grouped expert GEMM of LFM2's expert layer: no TPU kernel behind it
    "gemm_fp4_experts": ("qutlass_tpu_torch/csrc/gemm_fp4_experts.cu", None),
}
# the H100 SXM's published peaks: HBM3 rate, dense bf16, fp8 and int8 tensor
# cores, and fp32 and fp64 on the CUDA cores (printed beside a bound, never
# one: the least time of a bf16 rotation is the tensor cores'; K4's and K7's
# prefill kernel folds its exact group sums with fp64 FMAs, a floor of its
# design).
# e2m1 values (doubled) are exact in int8 and fp8, so a GEMM of fp4 operands
# is bounded at the int8 peak
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "fp8": 1979e12, "int8": 1979e12, "fp32": 67e12,
                  "fp64": 33.5e12}
ROT = 32


class SmokeFailure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def bound(nbytes: float, ops: float, kind: str):
    """(least ms, what bounds it): the larger of the bytes over the
    card's memory rate and the operations over its peak for ``kind``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def quantize_bound(m: int, k: int, out_bytes_per_elem: float, group: int,
                   extra_bytes: int = 0):
    """A rotate + quantize of bf16 [m, k]: read x once (2 B/elem) and the
    rotation, write codes and one scale byte per group; the rotation is
    a bf16 product of 2*ROT operations per element."""
    nbytes = 2 * m * k + 2 * ROT * ROT + m * k * out_bytes_per_elem + m * k // group
    return bound(nbytes + extra_bytes, 2 * ROT * m * k, "bf16")


def timed_ms(torch, fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` in ms: CUDA events around ``iters``
    calls after three warm-up calls.  The timed calls are queued behind
    a device-side sleep (~50 ms), so the card runs them back to back and
    the host's issue rate (tens of microseconds a call from Python) does
    not set the time of a small kernel."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def _recorder(results: dict):
    def record(name, shape, err, ms=None, plain_ms=None, extra="", bnd=None,
               lib=None):
        """Keep the largest error; keep times, bound and library time when
        ``shape`` is the timed one (N None for a quantizer)."""
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if shape[:2] == TIMED[:2] and shape[2] in (None, TIMED[2]) and ms is not None:
            r["ms"], r["plain_ms"] = ms, plain_ms
            r["bound_ms"], r["bound_by"] = bnd
            r["library_ms"] = lib
        times = "" if ms is None else f" ms={ms:.4f} plain_ms={plain_ms:.4f}"
        if bnd is not None:
            times += f" bound_ms={bnd[0]:.6f} ({bnd[1]})"
        if lib is not None:
            times += f" library_ms={lib:.4f}"
        print(f"phase 2 {name} M,K,N={shape} max_abs_err={err}{times}{extra}")
    return record


def _int_mm_ms(torch, a_mk, b_nk):
    """One library call computing K3's int8 product: torch._int_mm (int32
    out, no epilogue; cuBLAS takes M > 16 only).  None where it refuses."""
    try:
        a, b = a_mk.contiguous(), b_nk.contiguous().T
        return timed_ms(torch, lambda: torch._int_mm(a, b))
    except RuntimeError as e:
        print(f"phase 2 torch._int_mm refused {tuple(a_mk.shape)} x "
              f"{tuple(b_nk.shape)}: {str(e).splitlines()[0]}")
        return None


def gemm_bound(m, n, k, a_bytes, b_bytes, kind):
    """A GEMM: read both operands (and their scales) once, write bf16 C."""
    return bound(a_bytes + b_bytes + 2 * m * n, 2 * m * n * k, kind)


def _check_k3(torch, G, a_mk, b_nk, sa, sb, alpha, fn, tag) -> None:
    """K3 (``fn(out_dtype)``) bitwise against its plain version on the
    logical operands a' [M, K], b' [N, K], in fp32 and in bf16 (the plain
    bf16 is its fp32 result rounded once)."""
    want = G.gemm_int8_rank1_plain(a_mk, b_nk, sa, sb, alpha, torch.float32)
    require(torch.equal(fn(torch.float32), want), f"K3 fp32 differs from its plain version: {tag}")
    require(torch.equal(fn(torch.bfloat16), want.to(torch.bfloat16)),
            f"K3 bf16 differs from its plain version: {tag}")
    print(f"phase 2 gemm_int8_rank1 {tag}: bf16 and fp32 outputs bitwise")


# K3 in every order the paths give it.  Serving: "kmajor" (MX int8
# weights [N, K]) and "kk" (NV int8 weights [K, N]) at decode (M = 4) and
# prefill (M = 512) of Qwen3-8B's projections, (K, N): count a layer, and
# "nk" (both operands K-contiguous) beside them.  A QAT step of phase 6
# (4096 tokens, 4096 -> 12288 -> 4096), (M, K, N, order): count: the
# forward in "kk", the int8 backward's dgrad and wgrad in "nk"
K3_LINEARS = {(4096, 4096): 2, (4096, 1024): 2, (4096, 12288): 2, (12288, 4096): 1}
K3_QAT_STEP = {(4096, 4096, 12288, "kk"): 1, (4096, 12288, 4096, "kk"): 1,
               (4096, 12288, 4096, "nk"): 1, (12288, 4096, 4096, "nk"): 1,
               (4096, 4096, 12288, "nk"): 2}
K3_TARGET = {"decode": 1.0, "kmajor": 1.0, "nk": 1.0, "kk": 1.5}   # x the yardstick's time


def compare_k3(torch, results: dict, layers: int) -> None:
    """K3 at every shape and order above, bitwise in bf16 and fp32, timed
    beside its bound and its yardstick: bf16 ``torch.matmul`` at M <= 16
    (``torch._int_mm`` refuses it), ``torch._int_mm`` (int32 out, no
    epilogue) above; the ratio to the target, and K3's sum over a decode
    step (seven linears x ``layers``), a 512-row prefill and a QAT step."""
    from qutlass_tpu_torch.kernels import gemm as G

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    times = {}

    def case(m, k, n, orders):
        at = torch.randint(-127, 128, (k, m), generator=gen, device=dev, dtype=torch.int8)
        b = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
        sa = torch.rand(m, generator=gen, device=dev) + 0.01
        sb = torch.rand(n, generator=gen, device=dev) + 0.01
        am, bt = at.T.contiguous(), b.T.contiguous()
        bnd = gemm_bound(m, n, k, m * k + 4 * m, n * k + 4 * n, "int8")
        if m <= 16:
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            w = torch.randn((n, k), generator=gen, device=dev).to(torch.bfloat16)
            yard, lib = timed_ms(torch, lambda: x @ w.T), None
            del x, w
        else:
            yard = lib = _int_mm_ms(torch, am, b)
        yname = "bf16 torch.matmul" if m <= 16 else "torch._int_mm"
        iters = 5 if m > 512 else 20
        for order in orders:
            aa, bb = (am if order == "nk" else at), (bt if order == "kk" else b)
            fn = lambda od=torch.bfloat16: G.gemm_int8_rank1(   # noqa: E731
                aa, bb, sa, sb, 0.37, a_kmajor=order != "nk", b_kmajor=order == "kk",
                out_dtype=od)
            _check_k3(torch, G, at.T, b, sa, sb, 0.37, fn, f"{order} M,K,N={(m, k, n)}")
            ms = timed_ms(torch, fn, iters)
            times[m, k, n, order] = ms
            target = K3_TARGET["decode" if m <= 16 else order]
            ratio = ms / yard
            extra = ""
            if (m, k, n) == TIMED and order == "kmajor":
                plain = timed_ms(torch, lambda: G.gemm_int8_rank1_plain(at.T, b, sa, sb, 0.37), 5)
                results["gemm_int8_rank1"].update(ms=ms, plain_ms=plain, bound_ms=bnd[0],
                                                  bound_by=bnd[1], library_ms=lib)
                extra = f" plain_ms={plain:.4f}"
            print(f"phase 2 gemm_int8_rank1 {order} M,K,N={(m, k, n)} ms={ms:.4f}{extra} "
                  f"bound_ms={bnd[0]:.6f} ({bnd[1]}, {ms / bnd[0]:.1f}x) {yname} {yard:.4f} ms: "
                  f"{ratio:.3f}x, target <= {target}x {'met' if ratio <= target else 'MISSED'}")

    for m in SHAPES_M:
        for k, n in SHAPES_KN:
            case(m, k, n, ("kmajor", "kk", "nk"))
    for (m, k, n, order) in K3_QAT_STEP:
        if (m, k, n, order) not in times:
            case(m, k, n, [o for (mm, kk_, nn, o) in K3_QAT_STEP if (mm, kk_, nn) == (m, k, n)])
    for m in SHAPES_M:
        what = f"decode step (batch {m})" if m <= 16 else f"{m}-row prefill"
        for order, path in (("kmajor", "MX int8"), ("kk", "NV int8"), ("nk", "[M, K] x [N, K]")):
            tot = layers * sum(c * times[m, k, n, order] for (k, n), c in K3_LINEARS.items())
            print(f"phase 2 K3 in a {what}, {path} order ({order}), 7 linears x {layers} "
                  f"layers: {tot:.3f} ms")
    tot = sum(c * times[key] for key, c in K3_QAT_STEP.items())
    print(f"phase 2 K3 in an int8-mode QAT step (4096 tokens; forward kk x 2, dgrad and wgrad "
          f"nk x 2 layers): {tot:.3f} ms")


# the activation quantizer's calls in a layer of Qwen3-8B: (K, calls); the
# six projections at K = 4096 (q, k, v, o, gate, up) and down at 12288
QUANT_CALLS = {4096: 6, 12288: 1}


def quantizer_sums(torch, qtimes: dict, layers: int) -> None:
    """The activation quantizers' sums over a decode step (batch 4) and a
    512-row prefill from the phase 2 times in ``qtimes`` ({(name, M, K):
    ms}): K2 and K6 with int8-stored weights, K1 and K5 with fp4-stored
    ones, beside the least time of one launch on this card:
    ``torch.cuda._sleep(0)`` timed as the kernels are (at decode the byte
    bound is far below it)."""
    floor = timed_ms(torch, lambda: torch.cuda._sleep(0), 50)
    print(f"phase 2 launch floor: one torch.cuda._sleep(0) launch {floor:.4f} ms "
          f"(CUDA events, 50 launches back to back)")
    for name, path in (("quantize_mx_int8", "K2, MX int8"), ("quantize_nv_int8", "K6, NV int8"),
                       ("quantize_mx", "K1, MX fp4"), ("quantize_nv", "K5, NV fp4")):
        for m in SHAPES_M:
            what = f"decode step (batch {m})" if m <= 16 else f"{m}-row prefill"
            per = ", ".join(f"K={k} {qtimes[name, m, k]:.4f} ms"
                            + (f" ({qtimes[name, m, k] / floor:.1f}x the launch floor)"
                               if m <= 16 else "")
                            for k in QUANT_CALLS)
            tot = layers * sum(c * qtimes[name, m, k] for k, c in QUANT_CALLS.items())
            calls = " + ".join(f"{c} at K={k}" for k, c in QUANT_CALLS.items())
            print(f"phase 2 {path} in a {what}, ({calls}) x {layers} layers: {tot:.3f} ms; "
                  f"per call {per}")


# the linears of a layer of Qwen3-8B as (K, N): calls a layer; q and o,
# k and v, gate and up, down
LAYER_KN = {(4096, 4096): 2, (4096, 1024): 2, (4096, 12288): 2, (12288, 4096): 1}


def fold_floor_ms(m: int, n: int, k: int, group: int = 16) -> float:
    """The least time of the fp4 prefill kernel's fp64 fold: two fp64 FMAs
    (four operations) an output and group (16: K7, 32: K4), at the fp64
    peak."""
    return 4 * m * n * (k // group) / PEAK_OPS_PER_S["fp64"] * 1e3


def fp4_sums(torch, ktimes: dict, layers: int) -> None:
    """K4's and K7's sums over an fp4 decode step (batch 4) and a 512-row
    prefill from the phase 2 times in ``ktimes`` ({(name, M, K, N): ms}),
    beside the byte bound of the step's weights (1/2 + 1/group byte an
    element: 0.53125 MX, 0.5625 NV), the launch floor of its 7 x
    ``layers`` calls and, at a prefill, the floor of the prefill kernel's
    fp64 fold (a 32-group for K4, a 16-group for K7)."""
    floor = timed_ms(torch, lambda: torch.cuda._sleep(0), 50)
    calls = layers * sum(LAYER_KN.values())
    for name, kern, fmt, group in (("gemm_fp4_mx", "K4", "MX", 32),
                                   ("gemm_fp4_nv", "K7", "NV", 16)):
        weight_bytes = layers * sum(c * k * n * (0.5 + 1 / group) for (k, n), c in LAYER_KN.items())
        for m in SHAPES_M:
            what = f"an {fmt} fp4 decode step (batch {m})" if m <= 16 else \
                f"a {m}-row {fmt} fp4 prefill"
            tot = layers * sum(c * ktimes[name, m, k, n] for (k, n), c in LAYER_KN.items())
            per = ", ".join(f"(K, N)=({k}, {n}) {ktimes[name, m, k, n]:.4f} ms"
                            for k, n in LAYER_KN)
            floor_ms = layers * sum(c * fold_floor_ms(m, n, k, group)
                                    for (k, n), c in LAYER_KN.items())
            fold = "" if m <= 16 else f", fp64 fold floor {floor_ms:.3f} ms"
            print(f"phase 2 {kern} in {what}, 7 linears x {layers} layers ({calls} calls): "
                  f"{tot:.3f} ms; weight byte bound {weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} "
                  f"ms, launch floor {calls} x {floor:.4f} = {calls * floor:.3f} ms{fold}; per "
                  f"call {per}")


def compare_kernels(torch, results: dict, qtimes: dict, ktimes: dict) -> None:
    """K1-K4, the MXFP4 path's kernels; K2's times go to ``qtimes``, K4's
    to ``ktimes``."""
    import qutlass_tpu_torch as qt
    from qutlass_tpu_torch.kernels import gemm as G
    from qutlass_tpu_torch.kernels import quantize as Q
    from qutlass_tpu_torch.ops import dispatch
    from qutlass_tpu_torch.ops import emulation as E
    from qutlass_tpu_torch.ops import int8path as I8

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    h = qt.hadamard_matrix(ROT, device=dev)
    record = _recorder(results)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    def dq_rows(codes_rk, scales_gr):        # codes [rows, K], scales [K/32, rows]
        return E.dequant_fp4(codes_rk, scales_gr.T).float()

    def check_quantize(x, layout, shape, time_it):
        got = Q.quantize_mx(x, h, rot_size=32, layout=layout)
        want = Q.quantize_mx_plain(x, h, rot_size=32, layout=layout)
        require(all(torch.equal(a, b) for a, b in
                    zip(got, E.fused_quantize_mx_ordered_plain(x, h, rot_size=32, layout=layout))),
                f"K1 differs from its ordered plain version at {shape} {layout}")
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
        record("quantize_mx", shape, err, ms, plain, f" layout={layout} bitwise the ordered plain "
               f"version, code_mismatch={rate}", quantize_bound(*x.shape, 0.5, 32))
        if time_it:
            qtimes[("quantize_mx", *x.shape)] = ms
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
            record("quantize_mx_int8", shape, err, ms, plain, f" a_mismatch={rate}",
                   quantize_bound(m, k, 1.0, 32, 4 * m))
            qtimes["quantize_mx_int8", m, k] = ms
            acts[m, k] = (x, ga, gs)

    for k, n in SHAPES_KN:
        w = randn(n, k, scale=k ** -0.5)
        wqt, wst = check_quantize(w, "kmajor", (None, k, n), False)
        wi, sb, dw = I8.prepare_weight_int8(wqt, wst)
        for m in SHAPES_M:
            shape = (m, k, n)
            x, ai, sa = acts[m, k]
            # K3: the main path's GEMM on the path's operands (timed in
            # compare_k3)
            _check_k3(torch, G, ai.T, wi, sa, sb, 1.0,
                      lambda od: I8.matmul_mxf4_bf16_int8_kmajor(ai, wi, sa, sb, 1.0, od),
                      f"kmajor at {shape}")
            # K4: the fp4-weight GEMM, its decode kernel at M <= 16 and its
            # prefill kernel above: bitwise vs plain in bf16 and fp32, and vs
            # K3 at deficit <= 3
            xqt, xst = Q.quantize_mx(x, h, rot_size=32, layout="kmajor")
            kernel = "gemm_fp4_mx_decode" if m <= G.DECODE_M else "gemm_fp4_mx_prefill"
            before = dispatch.launch_counts[kernel]
            y4 = G.gemm_fp4_mx(xqt, wqt, xst, wst, 1.0, layout="kmajor")
            y32 = G.gemm_fp4_mx(xqt, wqt, xst, wst, 1.0, layout="kmajor",
                                out_dtype=torch.float32)
            want4 = G.gemm_fp4_mx_plain(xqt, wqt, xst, wst, 1.0, layout="kmajor")
            w32 = G.gemm_fp4_mx_plain(xqt, wqt, xst, wst, 1.0, layout="kmajor",
                                      out_dtype=torch.float32)
            require(dispatch.launch_counts[kernel] == before + 2, f"K4 did not run {kernel}")
            require(torch.equal(y4, want4) and torch.equal(y32, w32),
                    f"K4's {kernel} differs from its plain version at {shape}")
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
            bnd = gemm_bound(m, n, k, m * k // 2 + m * k // 32, n * k // 2 + n * k // 32, "int8")
            extra = f" {kernel}, bf16 and fp32 bitwise, vs_K3={same}"
            if m <= G.DECODE_M:
                extra += f", splits {G.fp4_decode_split(m, n, k, sms, 32)}"
            else:
                extra += f" fp64_fold_floor_ms={fold_floor_ms(m, n, k, 32):.6f}"
            record("gemm_fp4_mx", shape, 0.0, ms, plain, extra, bnd)
            ktimes["gemm_fp4_mx", m, k, n] = ms
            if (m, k, n) in (TIMED, (SHAPES_M[0], *TIMED[1:])):   # the kernel's row of the JSON line
                results[kernel].update(ms=ms, plain_ms=plain, bound_ms=bnd[0], bound_by=bnd[1])
    # the reference-parity drive: row-major quantize + matmul_mxf4_bf16_tn,
    # then the K-major layout with unpacked activation codes, both through
    # the prefill kernel, bitwise and timed at the prefill's gate / up shape
    m, k, n = TIMED
    x, w = randn(m, k), randn(n, k, scale=k ** -0.5)
    xq, xs = check_quantize(x, "rowmajor", (m, k, None), False)
    wq, ws = Q.quantize_mx(w, h, rot_size=32)
    before = dispatch.launch_counts["gemm_fp4_mx_prefill"]
    y = qt.matmul_mxf4_bf16_tn(xq, wq, qt.to_blocked(xs), qt.to_blocked(ws), 1.0)
    tn_ops = (xq, wq, xs[:m, :k // 32], ws[:n, :k // 32])
    want = G.gemm_fp4_mx_plain(*tn_ops, 1.0, layout="tn")
    require(torch.equal(y, want) and dispatch.launch_counts["gemm_fp4_mx_prefill"] == before + 1,
            "K4 tn layout differs from its plain version or did not run the prefill kernel")
    ms = timed_ms(torch, lambda: G.gemm_fp4_mx(*tn_ops, 1.0, layout="tn"))
    print(f"phase 2 gemm_fp4_mx M,K,N={(m, k, n)} layout=tn gemm_fp4_mx_prefill bitwise "
          f"ms={ms:.4f}")
    xc, xcs = Q.quantize_mx(x, h, rot_size=32, layout="kmajor_codes")
    wqt, wst = Q.quantize_mx(w, h, rot_size=32, layout="kmajor")
    before = dispatch.launch_counts["gemm_fp4_mx_prefill"]
    y = G.gemm_fp4_mx(xc, wqt, xcs, wst, 1.0, layout="kmajor_codes")
    want = G.gemm_fp4_mx_plain(xc, wqt, xcs, wst, 1.0, layout="kmajor_codes")
    require(torch.equal(y, want) and dispatch.launch_counts["gemm_fp4_mx_prefill"] == before + 1,
            "K4 kmajor_codes layout differs from its plain version or did not run the prefill "
            "kernel")
    ms = timed_ms(torch, lambda: G.gemm_fp4_mx(xc, wqt, xcs, wst, 1.0, layout="kmajor_codes"))
    print(f"phase 2 gemm_fp4_mx M,K,N={(m, k, n)} layout=kmajor_codes gemm_fp4_mx_prefill "
          f"bitwise ms={ms:.4f}")


# K4's prefill kernel and its warp-specialised one in turns: (512, 4096,
# 12288), then the long-prompt cell's prompt lengths on Qwen3-8B's four (K, N)
K4_PREFILL_SHAPES = (TIMED,) + tuple((m, k, n) for m in (345, 1596, 6523) for k, n in SHAPES_KN)


def compare_k4_prefill_kernels(torch) -> None:
    """K4's warp-specialised prefill kernel (``gemm_fp4_prefill_wg.cuh``,
    not in the library: built here by ``tools/time_mx_prefill_wg.py``)
    against K4 (``gemm_fp4_mx``, whose K-major calls above 16 rows run the
    prefill kernel) on the same K-major operands (every code; scale bytes
    120..135, so every fp64 sum is exact): bitwise each other (and the
    plain version at the timed shape), then timed in turns (K4, new, new,
    K4) beside the int8 bound and the fp64 fold floor."""
    import tempfile
    from qutlass_tpu_torch.kernels import gemm as G
    from qutlass_tpu_torch.tools import time_mx_prefill_wg as W

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    alpha = torch.tensor([0.37], device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        lib = W.build(Path(tmp))["this"]
        for m, k, n in K4_PREFILL_SHAPES:
            ops = W.operands(torch, gen, m, n, k, dev)
            old = G.gemm_fp4_mx(*ops, alpha, layout="kmajor")
            new = W.call(torch, lib, *ops, alpha)
            require(torch.equal(old, new), f"K4's prefill kernels differ at {(m, k, n)}")
            if (m, k, n) == TIMED:
                require(torch.equal(new, G.gemm_fp4_mx_plain(*ops, alpha, layout="kmajor")),
                        f"K4's prefill kernels differ from the plain version at {(m, k, n)}")
            t = [timed_ms(torch, fn) for fn in (
                lambda: G.gemm_fp4_mx(*ops, alpha, layout="kmajor"),
                lambda: W.call(torch, lib, *ops, alpha), lambda: W.call(torch, lib, *ops, alpha),
                lambda: G.gemm_fp4_mx(*ops, alpha, layout="kmajor"))]
            bnd = gemm_bound(m, n, k, m * k // 2 + m * k // 32, n * k // 2 + n * k // 32, "int8")
            print(f"phase 2 K4 prefill kernels M,K,N={(m, k, n)} bitwise; in turns prefill "
                  f"{t[0]:.4f} / {t[3]:.4f} ms, warp-specialised (not routed) {t[1]:.4f} / "
                  f"{t[2]:.4f} ms; bound_ms={bnd[0]:.6f} ({bnd[1]}), fp64_fold_floor_ms="
                  f"{fold_floor_ms(m, n, k, 32):.6f}")


def _ulp_diff(torch, a, b):
    """(mismatch rate, largest distance in bf16 ulps) of two bf16 tensors
    of finite values with equal signs."""
    ia, ib = a.view(torch.int16).int(), b.view(torch.int16).int()
    return (ia != ib).float().mean().item(), (ia - ib).abs().max().item()


def compare_nv_kernels(torch, results: dict, qtimes: dict, ktimes: dict) -> None:
    """K5-K7 and K3 in the NV path's K-major x K-major order; K6's times go
    to ``qtimes``, K7's to ``ktimes``."""
    import qutlass_tpu_torch as qt
    from qutlass_tpu_torch.formats.codecs import e2m1_decode_f32
    from qutlass_tpu_torch.kernels import gemm as G
    from qutlass_tpu_torch.kernels import quantize as Q
    from qutlass_tpu_torch.nn import linear as L
    from qutlass_tpu_torch.ops import dispatch
    from qutlass_tpu_torch.ops import emulation as E
    from qutlass_tpu_torch.ops import int8path as I8

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(1)
    h = qt.hadamard_matrix(ROT, device=dev)
    record = _recorder(results)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    def gscale(t):                       # the path's global scale, on the card
        return L.nv_global_scale(L.rotated_amax(t, h))

    def dec(codes):
        return e2m1_decode_f32(codes)

    def check_quantize(x, gs, layout, shape, time_it):
        got = Q.quantize_nv(x, h, gs, rot_size=ROT, layout=layout)
        want = Q.quantize_nv_plain(x, h, gs, rot_size=ROT, layout=layout)
        require(all(torch.equal(a, b) for a, b in zip(got, E.fused_quantize_nv_ordered_plain(
                    x, h, gs, rot_size=ROT, layout=layout))),
                f"K5 differs from its ordered plain version at {shape} {layout}")
        srate = (got[1] != want[1]).float().mean().item()
        require(srate <= CODE_BUDGET, f"K5 scale-byte mismatch {srate} at {shape} {layout}")
        unpack = (lambda q: E.unpack_codes(q.T).T) if layout == "kmajor" else E.unpack_codes
        cg, cw = unpack(got[0]), unpack(want[0])
        rate = (cg != cw).float().mean().item()
        require(rate <= CODE_BUDGET, f"K5 code mismatch {rate} at {shape} {layout}")
        err = (dec(cg) - dec(cw)).abs().max().item()
        ms = plain = None
        if time_it:
            ms = timed_ms(torch, lambda: Q.quantize_nv(x, h, gs, rot_size=ROT, layout=layout))
            plain = timed_ms(torch, lambda: Q.quantize_nv_plain(x, h, gs, rot_size=ROT,
                                                               layout=layout))
        record("quantize_nv", shape, err, ms, plain,
               f" layout={layout} bitwise the ordered plain version, scale_mismatch={srate} "
               f"code_mismatch={rate}", quantize_bound(*x.shape, 0.5, 16))
        if time_it:
            qtimes[("quantize_nv", *x.shape)] = ms
        return got

    acts = {}
    for m in SHAPES_M:
        for k in sorted({k for k, _ in SHAPES_KN}):
            x = randn(m, k)
            gs = gscale(x)
            shape = (m, k, None)
            xq = check_quantize(x, gs, "kmajor", shape, True)
            ga, gsig, gb = Q.quantize_nv_int8(x, h, gs, rot_size=ROT)
            wa, wsig, wb = Q.quantize_nv_int8_plain(x, h, gs, rot_size=ROT)
            srate = (gb != wb).float().mean().item()
            require(srate <= CODE_BUDGET, f"K6 scale-byte mismatch {srate} at {shape}")
            same = (gb == wb).all(0)
            require(torch.equal(ga[:, same], wa[:, same]) and torch.equal(gsig[same], wsig[same]),
                    f"K6 a' or sigma differ where the bytes agree at {shape}")
            err = ((ga.float() - wa.float()) * wsig[None, :]).abs().max().item()
            ms = timed_ms(torch, lambda: Q.quantize_nv_int8(x, h, gs, rot_size=ROT))
            plain = timed_ms(torch, lambda: Q.quantize_nv_int8_plain(x, h, gs, rot_size=ROT))
            record("quantize_nv_int8", shape, err, ms, plain,
                   f" scale_mismatch={srate} rows_with_equal_bytes={same.float().mean().item()}",
                   quantize_bound(m, k, 1.0, 16, 4 * m))
            qtimes["quantize_nv_int8", m, k] = ms
            acts[m, k] = (x, gs, xq, ga, gsig)

    # phase 8's small prefill: K7's prefill kernel at 64 rows too
    for k in sorted({k for k, _ in SHAPES_KN}):
        x = randn(K7_SMALL_M, k)
        gs = gscale(x)
        acts[K7_SMALL_M, k] = (x, gs, check_quantize(x, gs, "kmajor", (K7_SMALL_M, k, None),
                                                     False))
    for k, n in SHAPES_KN:
        w = randn(n, k, scale=k ** -0.5)
        gw = gscale(w)
        wqt, wst = check_quantize(w, gw, "kmajor", (None, k, n), False)
        wi, sb = I8.prepare_weight_nv_int8(wqt, wst)
        for m in (*SHAPES_M, K7_SMALL_M):
            shape = (m, k, n)
            x, gx, (xqt, xst), *int8_act = acts[m, k]
            alpha = 1.0 / (gx * gw)                      # on the card, as on the path
            if int8_act:
                # K3 in the K-major x K-major order of NV int8 weights, alpha
                # on the card (timed in compare_k3)
                ai, sa = int8_act
                _check_k3(torch, G, ai.T, wi.T, sa, sb, alpha,
                          lambda od: I8.matmul_mxf4_bf16_int8_kk(ai, wi, sa, sb, alpha, od),
                          f"kk (NV int8 weights [K, N]) at {shape}")
            # K7: the NV fp4-weight GEMM, its decode kernel at M <= 16 (exact
            # fp64 terms in another order) and its prefill kernel above (the
            # same terms in the same order): bitwise, in bf16 and fp32
            kernel = "gemm_fp4_nv_decode" if m <= G.DECODE_M else "gemm_fp4_nv_prefill"
            before = dispatch.launch_counts[kernel]
            y7 = G.gemm_fp4_nv(xqt, wqt, xst, wst, alpha, layout="kmajor")
            y32 = G.gemm_fp4_nv(xqt, wqt, xst, wst, alpha, layout="kmajor",
                                out_dtype=torch.float32)
            want7 = G.gemm_fp4_nv_plain(xqt, wqt, xst, wst, alpha, layout="kmajor")
            w32 = G.gemm_fp4_nv_plain(xqt, wqt, xst, wst, alpha, layout="kmajor",
                                      out_dtype=torch.float32)
            require(dispatch.launch_counts[kernel] == before + 2, f"K7 did not run {kernel}")
            require(torch.equal(y7, want7) and torch.equal(y32, w32),
                    f"K7's {kernel} differs from its plain version at {shape}")
            extra = f" {kernel}, bf16 and fp32 bitwise"
            if m <= G.DECODE_M:
                extra += f", splits {G.fp4_decode_split(m, n, k, sms, 16)}"
            err = (y7.float() - want7.float()).abs().max().item()
            ms = timed_ms(torch, lambda: G.gemm_fp4_nv(xqt, wqt, xst, wst, alpha,
                                                       layout="kmajor"))
            plain = timed_ms(torch, lambda: G.gemm_fp4_nv_plain(xqt, wqt, xst, wst, alpha,
                                                                layout="kmajor"))
            bnd = gemm_bound(m, n, k, m * k // 2 + m * k // 16, n * k // 2 + n * k // 16, "int8")
            if m > G.DECODE_M:
                extra += f" fp64_fold_floor_ms={fold_floor_ms(m, n, k):.6f}"
            if (m, k, n) == TIMED:
                # for scale, not a yardstick: bf16 torch.matmul of the decoded
                # operands (another function: bf16 rounding and fp32 sums)
                xd = E.dequant_nvfp4(E.unpack_codes(xqt.T), xst.T).to(torch.bfloat16)
                wd = E.dequant_nvfp4(E.unpack_codes(wqt.T), wst.T).to(torch.bfloat16)
                extra += f" torch_bf16_matmul_ms={timed_ms(torch, lambda: xd @ wd.T):.4f}"
                del xd, wd
            record("gemm_fp4_nv", shape, err, ms, plain, extra, bnd)
            ktimes["gemm_fp4_nv", m, k, n] = ms
            r = results[kernel]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if (m, k, n) in (TIMED, (SHAPES_M[0], *TIMED[1:])):   # the kernel's row of the JSON line
                r.update(ms=ms, plain_ms=plain, bound_ms=bnd[0], bound_by=bnd[1])
    # the reference-parity drive at tests/test_nvfp4.py's shape: row-major
    # quantize + matmul_nvf4_bf16_tn (K7's prefill kernel), bitwise
    m, n, k = 504, 512, 2048
    one = torch.tensor([1.0], device=dev)
    aq, asf = check_quantize(randn(m, k, scale=25.0), one, "rowmajor", (m, k, None), False)
    bq, bsf = check_quantize(randn(n, k, scale=25.0), one, "rowmajor", (n, k, None), False)
    before = dispatch.launch_counts["gemm_fp4_nv_prefill"]
    y = qt.matmul_nvf4_bf16_tn(aq, bq, asf, bsf, one)
    want = G.gemm_fp4_nv_plain(aq, bq, asf[:m, :k // 16], bsf[:n, :k // 16], one, layout="tn")
    require(torch.equal(y, want) and dispatch.launch_counts["gemm_fp4_nv_prefill"] == before + 1,
            "K7 tn layout differs from its plain version or did not run the prefill kernel")
    record("gemm_fp4_nv", (m, k, n), 0.0, extra=" layout=tn gemm_fp4_nv_prefill bitwise")


# ---------------------------------------------------------------------------
# phase 2, QAT: K8-K11 and K3 in the int8 backward's orders
# ---------------------------------------------------------------------------

# Qwen3-8B's hidden and intermediate widths, and benchmarks/bench_qat.py's
# token count; the example's lr (3e-3 at fan-in 256) overshoots at fan-in
# 4096 and 12288 (Adam's first steps move each weight by ~lr, a fifth of
# its std): with ``--qat-lr 3e-3`` the second step's loss is ~13x the
# first's on an H100 and the tenth is above the first, so the lr is
# scaled down with the width
QAT_D, QAT_H, QAT_TOKENS = 4096, 12288, 4096
QAT_STEPS, QAT_LR = 10, 3e-4
QAT_PATH = ("quantize_mx", "gemm_int8_rank1", "square_double_scaled", "square_double_mxfp8",
            "mxfp4_transpose_mxfp8", "gemm_fp8_mx")


def _bits_or_nan_equal(torch, got, want) -> bool:
    """bf16 tensors equal bit for bit, NaN where the other is NaN (a NaN's
    bf16 bits differ between PyTorch's CPU and CUDA casts)."""
    gn, wn = torch.isnan(got), torch.isnan(want)
    return bool(torch.equal(gn, wn)) and bool(
        torch.equal(got.view(torch.int16)[~gn], want.view(torch.int16)[~wn]))


def compare_qat_kernels(torch, results: dict) -> None:
    """K8-K11 at the training shapes of phase 6 (kernel times into the
    JSON line at layer 1's: dY [4096, 12288], W [12288, 4096], the dgrad
    GEMM), K3 in the int8 backward's two orders, and the training
    forward's K1 (with the clip mask) and K3 (K-major x K-major) at the
    sizes phase 6 gives them."""
    import qutlass_tpu_torch as qt
    from qutlass_tpu_torch.kernels import backward as B
    from qutlass_tpu_torch.kernels import gemm as G
    from qutlass_tpu_torch.kernels import quantize as Q
    from qutlass_tpu_torch.ops import emulation as E
    from qutlass_tpu_torch.ops import int8path as I8

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    h = qt.hadamard_matrix(ROT, device=dev)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    def record(name, shape, err, ms, plain_ms, bnd, main, extra="", lib=None):
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if main:
            r.update(ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1], library_ms=lib)
        print(f"phase 2 {name} {shape} max_abs_err={err} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bnd[0]:.6f} ({bnd[1]}){extra}")

    # K8/K9 on the output gradients of the two layers
    tiles = {}
    for m, n in ((QAT_TOKENS, QAT_H), (QAT_TOKENS, QAT_D)):
        dy = randn(m, n, scale=1e-3)
        f, e = B.square_double_mxfp8(dy)
        fw, ew = B.square_double_mxfp8_plain(dy)
        require(torch.equal(e, ew) and torch.equal(f, fw), f"K9 differs from its plain version at {(m, n)}")
        s, sw = B.square_double_scaled(dy), B.square_double_scaled_plain(dy)
        require(_bits_or_nan_equal(torch, s, sw), f"K8 differs from its plain version at {(m, n)}")
        err = (s.float() - sw.float()).nan_to_num(0.0).abs().max().item()
        main = n == QAT_H
        record("square_double_mxfp8", (m, n), 0.0, timed_ms(torch, lambda: B.square_double_mxfp8(dy)),
               timed_ms(torch, lambda: B.square_double_mxfp8_plain(dy)),
               bound(2 * m * n + m * n + m * n // 1024, 0, "bf16"), main, " bitwise")
        record("square_double_scaled", (m, n), err, timed_ms(torch, lambda: B.square_double_scaled(dy)),
               timed_ms(torch, lambda: B.square_double_scaled_plain(dy)),
               bound(4 * m * n, 0, "bf16"), main, " bitwise")
        tiles[n] = (f, e)

    # K10 on both weights and on the activation, quantized row-major by K1
    fp8s = {}
    for rows, cols, tag in ((QAT_H, QAT_D, "W1"), (QAT_D, QAT_H, "W2"), (QAT_TOKENS, QAT_D, "X")):
        src = randn(rows, cols, scale=1.0 if tag == "X" else cols ** -0.5)
        xq, xs = Q.quantize_mx(src, h, rot_size=ROT)
        require(all(torch.equal(a, b) for a, b in
                    zip((xq, xs), E.fused_quantize_mx_ordered_plain(src, h, rot_size=ROT))),
                f"K1 (row-major) differs from its ordered plain version on {tag}")
        sc = xs[:rows, :cols // 32]
        f, e = B.mxfp4_transpose_mxfp8(xq, sc)
        fw, ew = B.mxfp4_transpose_mxfp8_plain(xq, sc)
        require(torch.equal(e, ew) and torch.equal(f, fw), f"K10 differs from its plain version on {tag}")
        record("mxfp4_transpose_mxfp8", (tag, rows, cols), 0.0,
               timed_ms(torch, lambda: B.mxfp4_transpose_mxfp8(xq, sc)),
               timed_ms(torch, lambda: B.mxfp4_transpose_mxfp8_plain(xq, sc)),
               bound(rows * cols // 2 + rows * cols // 32 + rows * cols + rows * cols // 32, 0,
                     "bf16"), tag == "W1", " bitwise")
        fp8s[tag] = (f, e)

    # K11: the dgrad GEMM (tn) and the wgrad GEMM (nn) of the byte-level flow
    def check_fp8(layout, a, b, asf, bsf, main):
        a_mk = a if layout == "tn" else a.T
        (m, k), n = a_mk.shape, b.shape[0]
        y = G.gemm_fp8_mx(a, b, asf, bsf, 1.0, layout=layout)
        want = G.gemm_fp8_mx_plain(a, b, asf, bsf, 1.0, layout=layout)   # bf16(fp64 dequant matmul)
        rate, ulps = _ulp_diff(torch, y, want)
        require(rate <= 1e-3 and ulps <= 1, f"K11 {layout} vs plain: mismatch {rate}, {ulps} ulp")
        d = (y.float() - want.float()).abs()
        over = (d > 1e-1 + 1e-1 * want.float().abs()).float().mean().item()
        require(over == 0.0, f"K11 {layout} outside the reference's 1e-1 budget at a rate {over}")
        av, bv = E.dequant_fp8(a_mk, asf), E.dequant_fp8(b, bsf)
        bf16 = timed_ms(torch, lambda: av @ bv.T)
        record("gemm_fp8_mx", (layout, m, k, n), d.max().item(),
               timed_ms(torch, lambda: G.gemm_fp8_mx(a, b, asf, bsf, 1.0, layout=layout), 5),
               timed_ms(torch, lambda: G.gemm_fp8_mx_plain(a, b, asf, bsf, 1.0, layout=layout), 5),
               gemm_bound(m, n, k, m * k + m * k // 32, n * k + n * k // 32, "fp8"), main,
               f" mismatch={rate} max_ulp={ulps} outside_1e-1_budget={over} "
               f"torch_bf16_matmul_ms={bf16:.4f}")

    f1, e1 = tiles[QAT_H]
    w8, w8e = fp8s["W1"]
    check_fp8("tn", f1, w8, E.tile_scales(e1)[0], w8e, True)
    f2, e2 = tiles[QAT_D]
    x8, x8e = fp8s["X"]
    check_fp8("nn", f2, x8, E.tile_scales(e2)[1], x8e, False)

    # K3 in the int8 backward's orders: sb = 1, alpha = 1, bitwise
    ones = torch.ones(QAT_D, device=dev)
    for tag, a, b, sa in (
            ("dgrad", torch.randint(-127, 128, (QAT_TOKENS, QAT_H), generator=gen, device=dev,
                                    dtype=torch.int8),
             torch.randint(-96, 97, (QAT_D, QAT_H), generator=gen, device=dev, dtype=torch.int8),
             torch.rand(QAT_TOKENS, generator=gen, device=dev)),
            ("wgrad", torch.randint(-127, 128, (QAT_H, QAT_TOKENS), generator=gen, device=dev,
                                    dtype=torch.int8),
             torch.randint(-96, 97, (QAT_D, QAT_TOKENS), generator=gen, device=dev, dtype=torch.int8),
             torch.rand(QAT_H, generator=gen, device=dev))):
        _check_k3(torch, G, a, b, sa, ones, 1.0,
                  lambda od: G.gemm_int8_rank1(a, b, sa, ones, 1.0, a_kmajor=False,
                                               b_kmajor=False, out_dtype=od),
                  f"the int8 backward's {tag} order, M,K,N={(*a.shape, QAT_D)}")

    # the training forward's kernels at phase 6's sizes (quartet_forward):
    # K1 K-major on the activation with the clip mask and on the weight,
    # then K3 in the K-major x K-major order on their plane-major int8
    # encodes; all bitwise against the plain versions
    for m, k, n in ((QAT_TOKENS, QAT_D, QAT_H), (QAT_TOKENS, QAT_H, QAT_D)):
        x, w = randn(m, k), randn(n, k, scale=k ** -0.5)
        got = Q.quantize_mx(x, h, rot_size=ROT, return_mask=True, layout="kmajor")
        for want, what in ((E.fused_quantize_mx_ordered_plain, "ordered plain version"),
                           (Q.quantize_mx_plain, "plain version")):
            want = want(x, h, rot_size=ROT, return_mask=True, layout="kmajor")
            require(all(torch.equal(a, b) for a, b in zip(got, want)),
                    f"K1 (K-major, clip mask) differs from its {what} on x {(m, k)}: "
                    f"code, scale, mask bytes differing "
                    f"{[int((a != b).sum()) for a, b in zip(got, want)]}")
        wq = Q.quantize_mx(w, h, rot_size=ROT, layout="kmajor")
        for want, what in ((E.fused_quantize_mx_ordered_plain, "ordered plain version"),
                           (Q.quantize_mx_plain, "plain version")):
            require(all(torch.equal(a, b) for a, b in
                        zip(wq, want(w, h, rot_size=ROT, layout="kmajor"))),
                    f"K1 (K-major) differs from its {what} on w {(n, k)}")
        ms = timed_ms(torch, lambda: Q.quantize_mx(x, h, rot_size=ROT, return_mask=True,
                                                   layout="kmajor"))
        plain = timed_ms(torch, lambda: Q.quantize_mx_plain(x, h, rot_size=ROT, return_mask=True,
                                                           layout="kmajor"), 5)
        bnd = quantize_bound(m, k, 0.5 + 1 / 8, 32)
        print(f"phase 2 quantize_mx training forward x {(m, k)} kmajor with mask: codes, scales "
              f"and mask bitwise the ordered plain and plain versions ms={ms:.4f} plain_ms={plain:.4f} bound_ms={bnd[0]:.6f} "
              f"({bnd[1]}); w {(n, k)} bitwise")
        (xi, sx, _), (wi, sw, _) = I8.encode_int8_planes(*got[:2]), I8.encode_int8_planes(*wq)
        _check_k3(torch, G, xi.T, wi.T, sx, sw, 1.0,
                  lambda od: I8.matmul_mxf4_bf16_int8_kk(xi, wi, sx, sw, 1.0, od),
                  f"kk at the training forward {(m, k, n)}")


# ---------------------------------------------------------------------------
# phase 2, the backward-operand ops: K12-K15 at phase 7's shapes
# ---------------------------------------------------------------------------

BWD_OPS = ("backward_t_bf16", "backward_qt_bf16", "mxfp4_transpose_scaled",
           "mxfp4_transpose_scaled_kmajor")


def compare_bwd_op_kernels(torch, results: dict) -> None:
    """K12 on dY [4096, 12288] and x [4096, 4096], K13 on the row-major
    abs-max MXFP4 of W1 [12288, 4096] and of x (alpha 3), K14 on the
    row-major QuEST MXFP4 of both and K15 on their K-major twins, each
    against its plain version on the card; W1's (dY's for K12) times go
    to the JSON line.  K14 and K15 are bitwise (K14 also against the
    decode of K10), K12 and K13 must have equal scale bytes and a code
    mismatch rate within the MX budget (the rotation's fp32 sums run in
    another order than cuBLAS's)."""
    import qutlass_tpu_torch as qt
    from qutlass_tpu_torch.formats import codecs as C
    from qutlass_tpu_torch.kernels import backward as B
    from qutlass_tpu_torch.kernels import quantize as Q
    from qutlass_tpu_torch.ops import emulation as E

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    h = qt.hadamard_matrix(ROT, device=dev)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    def record(name, shape, err, fn, plain_fn, nbytes, ops, main, extra=""):
        ms, plain_ms = timed_ms(torch, fn), timed_ms(torch, plain_fn, 5)
        bnd = bound(nbytes, ops, "bf16")
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if main:
            r.update(ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1], library_ms=None)
        print(f"phase 2 {name} {shape} max_abs_err={err} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bnd[0]:.6f} ({bnd[1]}){extra}")

    def check_codes(name, tag, got, want):
        """Scale bytes equal; (code mismatch count, rate, largest
        difference of the dequantized values)."""
        (q, s), (qw, sw) = got, want
        require(torch.equal(s, sw), f"{name} scale bytes differ from its plain version on {tag}")
        cg, cw = E.unpack_codes(q), E.unpack_codes(qw)
        bad = int((cg != cw).sum())
        rate = bad / cg.numel()
        require(rate <= CODE_BUDGET, f"{name} code mismatch {rate} on {tag}")
        err = (E.dequant_fp4(cg, s).float() - E.dequant_fp4(cw, s).float()).abs().max().item()
        return bad, rate, err

    al = torch.tensor([3.0], device=dev)
    for tag, (n, k), scale in (("dY", (QAT_TOKENS, QAT_H), 1e-3), ("x", (QAT_TOKENS, QAT_D), 1.0)):
        x = randn(n, k, scale=scale)
        bad, rate, err = check_codes("K12", tag, B.backward_t_bf16(x, h, rot_size=ROT),
                                     B.backward_t_bf16_plain(x, h, rot_size=ROT))
        fp32_ms = 2 * ROT * n * k / PEAK_OPS_PER_S["fp32"] * 1e3
        record("backward_t_bf16", (tag, n, k), err,
               lambda: B.backward_t_bf16(x, h, rot_size=ROT),
               lambda: B.backward_t_bf16_plain(x, h, rot_size=ROT),
               2 * n * k + 2 * ROT * ROT + n * k // 2 + n * k // 32, 2 * ROT * n * k, tag == "dY",
               f" scale bytes equal, code mismatches {bad} (rate {rate}); the rotation on the "
               f"fp32 CUDA cores alone {fp32_ms:.6f} ms")
    for tag, (m, n), scale in (("W1", (QAT_H, QAT_D), QAT_D ** -0.5), ("x", (QAT_TOKENS, QAT_D), 1.0)):
        src = randn(m, n, scale=scale)
        xq, xs = Q.quantize_mx(src, h, rot_size=ROT, method="abs_max")
        sc = xs[:m, :n // 32]
        bad, rate, err = check_codes("K13", tag, B.backward_qt_bf16(xq, sc, h, al, rot_size=ROT),
                                     B.backward_qt_bf16_plain(xq, sc, h, al, rot_size=ROT))
        nbytes = 2 * (m * n // 2 + m * n // 32) + 2 * ROT * ROT + 4
        record("backward_qt_bf16", (tag, m, n), err,
               lambda: B.backward_qt_bf16(xq, sc, h, al, rot_size=ROT),
               lambda: B.backward_qt_bf16_plain(xq, sc, h, al, rot_size=ROT),
               nbytes, 2 * ROT * m * n, tag == "W1",
               f" alpha 3, scale bytes equal, code mismatches {bad} (rate {rate})")

        # K14 and K15 on the QuEST operand, row-major and K-major
        xq, xs = Q.quantize_mx(src, h, rot_size=ROT)
        sc = xs[:m, :n // 32]
        y = B.mxfp4_transpose_scaled(xq, sc)
        require(_bits_or_nan_equal(torch, y, B.mxfp4_transpose_scaled_plain(xq, sc)),
                f"K14 differs from its plain version on {tag}")
        f8, e8 = B.mxfp4_transpose_mxfp8(xq, sc)
        dec = (C.e4m3_decode_f32(f8) * C.e8m0_decode_f32(e8).repeat_interleave(32, 1))
        require(_bits_or_nan_equal(torch, y, dec.to(torch.bfloat16)),
                f"K14 differs from the decode of K10 on {tag}")
        nbytes = m * n // 2 + m * n // 32 + 2 * m * n
        record("mxfp4_transpose_scaled", (tag, m, n), 0.0, lambda: B.mxfp4_transpose_scaled(xq, sc),
               lambda: B.mxfp4_transpose_scaled_plain(xq, sc), nbytes, 0, tag == "W1",
               " bitwise, and bitwise against the decode of K10")
        qk, sk = Q.quantize_mx(src, h, rot_size=ROT, layout="kmajor")
        yk = B.mxfp4_transpose_scaled_kmajor(qk, sk)
        require(_bits_or_nan_equal(torch, yk, B.mxfp4_transpose_scaled_kmajor_plain(qk, sk)),
                f"K15 differs from its plain version on {tag}")
        require(_bits_or_nan_equal(torch, yk, y), f"K15 differs from K14 on {tag}")
        record("mxfp4_transpose_scaled_kmajor", (tag, n, m), 0.0,
               lambda: B.mxfp4_transpose_scaled_kmajor(qk, sk),
               lambda: B.mxfp4_transpose_scaled_kmajor_plain(qk, sk), nbytes, 0, tag == "W1",
               " bitwise, and bitwise against K14 on the row-major operand")


# ---------------------------------------------------------------------------
# phase 2, the single-kernel linears: K16 and K17 at Qwen3-8B MLP shapes
# ---------------------------------------------------------------------------

# (M, K, N): every shape phase 8 gives K16 and K17 (decode, small prefill
# and the training batch, into the gate/up width and out of the down
# projection) and the serving rows' M = 512 (the JSON line's)
FL_SHAPES = ((4, 4096, 12288), (64, 4096, 12288), (4, 12288, 4096), (64, 12288, 4096),
             (512, 4096, 12288), (4096, 4096, 12288), (4096, 12288, 4096))
FL_NV_GSX, FL_NV_ALPHA = 37.5, 0.7


def compare_fused_linear_kernels(torch, results: dict) -> None:
    """K16 (QuEST and abs-max) and K17 (abs-max, activation global scale
    37.5, alpha 0.7) at FL_SHAPES, each bitwise against its plain version
    and against the composition it replaces on the card (K1 K-major + K4,
    K5 K-major + K7), with the times of all three."""
    import qutlass_tpu_torch as qt
    from qutlass_tpu_torch.kernels import fused_linear as FL
    from qutlass_tpu_torch.kernels import gemm as G
    from qutlass_tpu_torch.kernels import quantize as Q
    from qutlass_tpu_torch.nn import linear as L

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    h = qt.hadamard_matrix(ROT, device=dev)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    def mx_case(x, w, method):
        # K4 takes a host alpha (no sync in the timed loop), K16 a device one
        al = 1.0 if method == "quest" else float(torch.tensor(1 / 9, dtype=torch.float32))
        al_dev = torch.full((), al, device=dev)
        wqt, wst = Q.quantize_mx(w, h, rot_size=ROT, method=method, layout="kmajor")
        kw = dict(rot_size=ROT, method=method)
        return ("fused_linear_mx", method, wst.numel(),
                lambda: FL.fused_linear_mx(x, wqt, wst, h, al_dev, **kw),
                lambda: FL.fused_linear_mx_plain(x, wqt, wst, h, al_dev, **kw),
                lambda: _compose_mx(G, Q, x, h, wqt, wst, al, kw))

    def nv_case(x, w):
        nqt, nst = Q.quantize_nv(w, h, L.nv_global_scale(L.rotated_amax(w, h)), rot_size=ROT,
                                 layout="kmajor")
        gsx = torch.full((), FL_NV_GSX, device=dev)
        al = torch.full((), FL_NV_ALPHA, device=dev)
        kw = dict(rot_size=ROT, method="abs_max")
        return ("fused_linear_nv", "abs_max", nst.numel(),
                lambda: FL.fused_linear_nv(x, nqt, nst, h, gsx, al, **kw),
                lambda: FL.fused_linear_nv_plain(x, nqt, nst, h, gsx, al, **kw),
                lambda: _compose_nv(G, Q, x, h, gsx, nqt, nst, al, kw))

    for m, k, n in FL_SHAPES:
        x, w = randn(m, k), randn(n, k, scale=k ** -0.5)
        cases = [mx_case(x, w, "quest"), mx_case(x, w, "abs_max"), nv_case(x, w)]
        for name, method, scale_bytes, fn, plain_fn, comp_fn in cases:
            y, want, comp = fn(), plain_fn(), comp_fn()
            require(torch.equal(y, want), f"{name} {method} differs from its plain version at "
                                          f"{(m, k, n)}: {int((y != want).sum())} outputs")
            require(torch.equal(y, comp), f"{name} {method} differs from the composition at "
                                          f"{(m, k, n)}: {int((y != comp).sum())} outputs")
            iters = 3 if m > 512 else 10      # ~0.1 s a call at M = 4096
            ms, plain_ms = timed_ms(torch, fn, iters), timed_ms(torch, plain_fn, min(iters, 5))
            comp_ms = timed_ms(torch, comp_fn, iters)
            # the fp4 GEMM at the int8 peak, the bf16 rotation (2 * ROT * m * k) at
            # half of it
            bnd = bound(2 * m * k + n * k // 2 + scale_bytes + 2 * m * n,
                        2 * m * n * k + 4 * ROT * m * k, "int8")
            if (m, k, n) == TIMED and (name == "fused_linear_nv" or method == "quest"):
                results[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1], library_ms=None)
            print(f"phase 2 {name} {method} M,K,N={(m, k, n)} max_abs_err=0.0 ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} composition_ms={comp_ms:.4f} bound_ms={bnd[0]:.6f} "
                  f"({bnd[1]}) bitwise vs plain and vs the composition")


def _compose_mx(G, Q, x, h, wqt, wst, alpha, kw):
    """The composition K16 replaces: K1 K-major on x, then K4."""
    xqt, xst = Q.quantize_mx(x, h, layout="kmajor", **kw)
    return G.gemm_fp4_mx(xqt, wqt, xst, wst, alpha, layout="kmajor")


def _compose_nv(G, Q, x, h, gsx, wqt, wst, alpha, kw):
    """The composition K17 replaces: K5 K-major on x, then K7."""
    xqt, xst = Q.quantize_nv(x, h, gsx, layout="kmajor", **kw)
    return G.gemm_fp4_nv(xqt, wqt, xst, wst, alpha, layout="kmajor")


# ---------------------------------------------------------------------------
# phase 4: serve at Qwen3-8B width
# ---------------------------------------------------------------------------

MX_PATH = ("quantize_mx", "quantize_mx_int8", "gemm_int8_rank1", "gemm_fp4_mx",
           "gemm_fp4_mx_decode", "gemm_fp4_mx_prefill")
NV_PATH = ("quantize_nv", "quantize_nv_int8", "gemm_int8_rank1", "gemm_fp4_nv",
           "gemm_fp4_nv_decode", "gemm_fp4_nv_prefill")


LFM2_DECODE = (64, 4, 8)        # LFM2-24B-A2B's experts and top-k, a decode step of 8 tokens
LFM2_EXPERT_KN = ((2048, 1536, True), (1536, 2048, False))  # (K, N, rows gathered): gate, down


def compare_experts_kernel(torch, results: dict) -> None:
    """K18, the grouped expert GEMM, at LFM2-24B-A2B's decode shapes: 8
    tokens routed to the top 4 of 64 experts, the gate / up projection
    (K, N) = (2048, 1536) reading the tokens' rows through ``rows``, the
    down projection (1536, 2048) on the 32 routed rows; bitwise against
    its plain version (K4's on each expert's rows), its routing counter
    against the routing, and timed beside the bound of reading each
    routed expert's weight once (and the rows' codes, scales and bf16
    outputs) at the int8 peak."""
    import qutlass_tpu_torch as qt
    from qutlass_tpu_torch.kernels import gemm as G
    from qutlass_tpu_torch.models import experts as X
    from qutlass_tpu_torch.ops import dispatch
    from qutlass_tpu_torch.ops import emulation as E

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    h = qt.hadamard_matrix(ROT, device=dev)
    e, top, tokens = LFM2_DECODE
    idx = torch.rand((tokens, e), generator=gen, device=dev).topk(top, dim=-1).indices
    _, rows, offsets = X.dispatch(idx, e)
    per_expert = offsets.diff().long()
    active, r = int((per_expert > 0).sum()), tokens * top
    for k, n, gathered in LFM2_EXPERT_KN:
        w = (torch.randn((e, n, k), generator=gen, device=dev) * k ** -0.5).to(torch.bfloat16)
        st = X.quantize_stacked(w, h)
        del w
        x = torch.randn((tokens if gathered else r, k), generator=gen, device=dev)
        xqt, xst = qt.fusedQuantizeMx(x.to(torch.bfloat16), h, method="quest", layout="kmajor")
        rw = rows if gathered else None
        counts = torch.zeros((2, e), dtype=torch.int64, device=dev)
        before = dispatch.launch_counts["gemm_fp4_experts"]
        y = G.gemm_fp4_experts(xqt, xst, st["wqt"], st["wst"], offsets, 1.0, rows=rw,
                               max_rows=tokens, counts=counts)
        want = E.gemm_fp4_experts_plain(xqt, xst, st["wqt"], st["wst"], offsets, 1.0, rows=rw)
        shape = (r, k, n)
        require(dispatch.launch_counts["gemm_fp4_experts"] == before + 1,
                f"K18 did not run at {shape}")
        require(torch.equal(counts, torch.stack([per_expert, (per_expert > 0).long()])),
                f"K18's routing counter {counts.tolist()} is not the routing's at {shape}")
        err = (y.float() - want.float()).abs().max().item()
        require(err == 0.0 and torch.equal(y, want),
                f"K18 differs from its plain version at {shape}: max_abs_err {err}")
        ms = timed_ms(torch, lambda: G.gemm_fp4_experts(xqt, xst, st["wqt"], st["wst"], offsets,
                                                        1.0, rows=rw, max_rows=tokens))
        plain = timed_ms(torch, lambda: E.gemm_fp4_experts_plain(
            xqt, xst, st["wqt"], st["wst"], offsets, 1.0, rows=rw), 3)
        bnd = bound(active * (n * k // 2 + n * k // 32) + r * (k // 2 + k // 32) + 2 * r * n,
                    2 * r * n * k, "int8")
        res = results["gemm_fp4_experts"]
        res["max_abs_err"] = max(res["max_abs_err"], err)
        if gathered:                       # the gate / up shape is the row's timed one
            res.update(ms=ms, plain_ms=plain, bound_ms=bnd[0], bound_by=bnd[1], library_ms=None)
        print(f"phase 2 gemm_fp4_experts R,K,N={shape} experts={e} active={active} "
              f"rows={'gathered' if gathered else 'in order'} max_abs_err={err} ms={ms:.4f} "
              f"plain_ms={plain:.4f} bound_ms={bnd[0]:.6f} ({bnd[1]}) bitwise, routing counter "
              f"equal")


def sync_ms(torch, t0):
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def requests(torch, cfg, steps: int):
    """The seeded model inputs: generator (for the weights), rotation, the
    four right-padded ragged prompts and their lengths, and max_len."""
    import qutlass_tpu_torch as qt
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    t = max(LENS)
    lengths = torch.tensor(LENS, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (len(LENS), t), generator=gen, device=dev)
    prompt = prompt.masked_fill(torch.arange(t, device=dev)[None] >= lengths[:, None], 0)
    return gen, qt.hadamard_matrix(ROT, device=dev), prompt, lengths, t + steps


def run_and_replay(torch, M, cfg, params, prompt, h, lengths, max_len, steps, tag):
    """Warm up, then time prefill and generate on the host clock, and check
    the generated tokens against a step-by-step replay (also timed).
    Returns (prefill logits, tokens, prefill ms, decode ms/step, generate ms)."""
    run = dict(quantized=True, lengths=lengths)
    M.generate(cfg, params, prompt, h, steps=2, max_len=max_len, **run)   # warm-up
    t0 = time.perf_counter()
    logits, _ = M.prefill(cfg, params, prompt, h, max_len=max_len, **run)
    prefill_ms = sync_ms(torch, t0)
    t0 = time.perf_counter()
    toks, lps = M.generate(cfg, params, prompt, h, steps=steps, max_len=max_len,
                           return_logprobs=True, **run)
    generate_ms = sync_ms(torch, t0)
    require(tuple(toks.shape) == (len(LENS), steps), f"{tag}: tokens shape {tuple(toks.shape)}")
    require(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), f"{tag}: token out of range")
    require(bool(torch.isfinite(logits).all()) and bool(torch.isfinite(lps).all()),
            f"{tag}: non-finite logits or logprobs")
    # the served tokens equal a step-by-step replay of prefill + decode
    lg, cache = M.prefill(cfg, params, prompt, h, max_len=max_len, **run)
    require(torch.equal(lg, logits), f"{tag}: prefill is not deterministic")
    tok, replay, pos = lg.argmax(-1), [], lengths.clone()
    t0 = time.perf_counter()
    for _ in range(steps):
        replay.append(tok)
        lg, cache = M.decode_step(cfg, params, cache, tok, pos, h, quantized=True)
        tok, pos = lg.argmax(-1), pos + 1
    ms_per_token = sync_ms(torch, t0) / steps
    require(torch.equal(torch.stack(replay, 1), toks), f"{tag}: generate differs from the replay")
    return logits, toks, prefill_ms, ms_per_token, generate_ms


def cosine(a, b) -> float:
    a, b = a.float().ravel(), b.float().ravel()
    return float(a @ b / (a.norm() * b.norm()))


def serve(torch, layers: int, steps: int) -> dict:
    """Phase 4, the MXFP4 path."""
    from qutlass_tpu_torch import models as M
    from qutlass_tpu_torch.models.transformer import PROJECTIONS
    from qutlass_tpu_torch.ops import dispatch

    cfg = dataclasses.replace(M.QWEN3_8B, num_layers=layers)
    if layers != M.QWEN3_8B.num_layers:
        print(f"phase 4 depth cut: {layers} of {M.QWEN3_8B.num_layers} layers")
    gen, h, prompt, lengths, max_len = requests(torch, cfg, steps)

    dispatch.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, gen)
    w_int8 = M.quantize_model_weights(cfg, params, h)
    w_fp4 = M.quantize_model_weights(cfg, params, h, weight_format="fp4")
    del params
    load_ms = sync_ms(torch, t0)
    fallback = sum("wqt" in layer[n] for layer in w_int8["layers"] for n in PROJECTIONS)
    print(f"phase 4 weights: {7 * layers} projections quantized twice in {load_ms:.0f} ms; "
          f"int8 storage keeps {fallback} as fp4 (deficit > 3)")

    run = dict(quantized=True, lengths=lengths)
    logits, toks, prefill_ms, ms_per_token, generate_ms = run_and_replay(
        torch, M, cfg, w_int8, prompt, h, lengths, max_len, steps, "phase 4 MX int8")
    # the same requests with fp4-stored weights (kernels K1 + K4: its decode
    # kernel at every decode step, its prefill kernel at the prefill)
    logits4, toks4, prefill4, ms_per_token4, generate4 = run_and_replay(
        torch, M, cfg, w_fp4, prompt, h, lengths, max_len, steps, "phase 4 MX fp4")
    torch.cuda.synchronize()
    counts = dict(dispatch.launch_counts)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    cos = cosine(logits, logits4)
    require(bool(torch.isfinite(logits4).all()), "non-finite fp4 logits")
    # per linear the two storages agree bitwise wherever the activation
    # row's deficit is <= 3; rows beyond it round in the int8 evaluator,
    # and 36 random-weight W4A4 layers amplify that (0.958 measured on the
    # H100), so this bounds gross faults only
    require(cos > 0.9, f"fp4-stored vs int8-stored prefill logits cosine {cos}")
    agree = float((toks4 == toks).float().mean())
    print(f"phase 4 int8 weights: prefill {prefill_ms:.1f} ms for {sum(LENS)} prompt tokens "
          f"(4 ragged requests, lengths {LENS}), decode {ms_per_token:.2f} ms/step "
          f"(batch 4, {steps} steps), generate {generate_ms:.1f} ms; host clock "
          f"after a warm-up")
    print(f"phase 4 fp4 weights: prefill {prefill4:.1f} ms, decode {ms_per_token4:.2f} "
          f"ms/step (batch 4, {steps} steps), generate {generate4:.1f} ms; host clock after a "
          f"warm-up; tokens equal the replay")
    print(f"phase 4 fp4 weights: prefill logits cosine to int8 weights {cos:.6f}, "
          f"token agreement {agree:.3f}")
    print(f"phase 4 peak device memory {peak_gib:.2f} GiB; launch counts {counts}")
    for name in MX_PATH:
        require(counts[name] > 0, f"kernel {name} was not launched by the MX path")
    print(f"phase 4 first request's tokens: {toks[0, :16].tolist()}")
    return counts


def serve_nv(torch, layers: int, steps: int) -> dict:
    """Phase 5, the NVFP4 path: int8-stored weights with the exact
    per-call activation scale, then with calibrated static scales, then
    fp4-stored weights."""
    from qutlass_tpu_torch import models as M
    from qutlass_tpu_torch.ops import dispatch

    cfg = dataclasses.replace(M.QWEN3_8B, num_layers=layers)
    if layers != M.QWEN3_8B.num_layers:
        print(f"phase 5 depth cut: {layers} of {M.QWEN3_8B.num_layers} layers")
    gen, h, prompt, lengths, max_len = requests(torch, cfg, steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    params = M.init_params(cfg, gen)
    w_int8 = M.quantize_model_weights(cfg, params, h, fmt="nv")
    w_fp4 = M.quantize_model_weights(cfg, params, h, fmt="nv", weight_format="fp4")
    del params
    print(f"phase 5 weights: {7 * layers} projections quantized to NVFP4 twice (int8 and "
          f"fp4 storage) in {sync_ms(torch, t0):.0f} ms")

    exact = run_and_replay(torch, M, cfg, w_int8, prompt, h, lengths, max_len, steps,
                           "phase 5 NV int8 exact gsx")
    t0 = time.perf_counter()
    M.calibrate_nv_gsx(cfg, w_int8, prompt, h)
    calib_ms = sync_ms(torch, t0)
    static = run_and_replay(torch, M, cfg, w_int8, prompt, h, lengths, max_len, steps,
                            "phase 5 NV int8 static gsx")
    fp4 = run_and_replay(torch, M, cfg, w_fp4, prompt, h, lengths, max_len, steps,
                         "phase 5 NV fp4")
    logits4, toks4 = fp4[0], fp4[1]
    torch.cuda.synchronize()
    counts = dict(dispatch.launch_counts)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    require(bool(torch.isfinite(logits4).all()), "non-finite NV fp4 logits")
    cos4 = cosine(exact[0], logits4)
    # the int8 storage rounds each weight row to int8 (<= rowmax/254) and
    # each activation row likewise; fp4 storage evaluates the NVFP4 values
    # exactly, and 36 random-weight W4A4 layers amplify the difference
    require(cos4 > 0.9, f"NV fp4-stored vs int8-stored prefill logits cosine {cos4}")
    for tag, (_, _, pre, dec, gen_ms) in (("int8 weights, exact gsx", exact),
                                          ("int8 weights, static gsx", static),
                                          ("fp4 weights, exact gsx", fp4)):
        print(f"phase 5 NV {tag}: prefill {pre:.1f} ms for {sum(LENS)} prompt "
              f"tokens (4 ragged requests, lengths {LENS}), decode {dec:.2f} ms/step "
              f"(batch 4, {steps} steps), generate {gen_ms:.1f} ms; host clock after a "
              f"warm-up; tokens equal the replay")
    print(f"phase 5 calibration (one forward over the prompts) {calib_ms:.0f} ms; static vs "
          f"exact gsx: prefill logits cosine {cosine(exact[0], static[0]):.6f}, token "
          f"agreement {float((static[1] == exact[1]).float().mean()):.3f}")
    print(f"phase 5 NV fp4 weights: prefill logits cosine to int8 weights {cos4:.6f}, "
          f"token agreement {float((toks4 == exact[1]).float().mean()):.3f}")
    print(f"phase 5 peak device memory {peak_gib:.2f} GiB; launch counts {counts}")
    for name in NV_PATH:
        require(counts[name] > 0, f"kernel {name} was not launched by the NV path")
    print(f"phase 5 first request's tokens: {exact[1][0, :16].tolist()}")
    return counts


# ---------------------------------------------------------------------------
# phase 6: Quartet QAT training at Qwen3-8B MLP width
# ---------------------------------------------------------------------------

def _planes_to_natural(v):
    """[R, K] with K plane-major (column p = element 2p, K/2 + p = 2p+1)
    -> natural order."""
    r, k = v.shape
    return v.reshape(r, 2, k // 2).transpose(1, 2).reshape(r, k)


def train_qat(torch, lr: float = QAT_LR):
    """Phase 6: the QAT example's MLP at Qwen3-8B width trained with Adam
    in each grad mode; gradient cosines against the exact STE; the
    reference's byte-level MXFP8 backward flow on layer 1.  Returns the
    phase's launch counts, layer 1's operands at the initial weights (x,
    W1, the rotation, dY at y1, and the byte-level flow's dXh and dWh)
    for phase 7, and the MLP's weights after the last grad mode's steps
    for phase 8."""
    import torch.nn.functional as F
    import qutlass_tpu_torch as qt
    from qutlass_tpu_torch.nn import linear as L
    from qutlass_tpu_torch.ops import dispatch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    mlp = L.QuartetMLP(QAT_D, QAT_H, QAT_D, rot_size=ROT, method="quest", device=dev,
                       generator=gen)
    init = {k: v.clone() for k, v in mlp.state_dict().items()}
    teacher = torch.randn((QAT_D, QAT_D), generator=gen, device=dev) * QAT_D ** -0.5
    xs = [torch.randn((QAT_TOKENS, QAT_D), generator=gen, device=dev).to(torch.bfloat16)
          for _ in range(QAT_STEPS)]
    targets = [x.float() @ teacher.T for x in xs]

    def loss_of(i):
        return ((mlp(xs[i]).float() - targets[i]) ** 2).mean()

    # the first step's weight gradients in each mode, against the exact STE
    grads = {}
    for mode in ("bf16", "int8", "mxfp8"):
        mlp.load_state_dict(init)
        mlp.set_grad_mode(mode)
        mlp.zero_grad(set_to_none=True)
        loss_of(0).backward()
        grads[mode] = [mlp.fc1.weight.grad.clone(), mlp.fc2.weight.grad.clone()]
    cos = {mode: [cosine(a, b) for a, b in zip(grads[mode], grads["bf16"])]
           for mode in ("int8", "mxfp8")}
    print(f"phase 6 first-step weight gradient cosines to the exact STE (bf16 mode), "
          f"[w1, w2]: int8 {cos['int8']}, mxfp8 {cos['mxfp8']}")
    require(min(cos["int8"]) >= 0.999, f"int8 gradients too far from the exact STE: {cos['int8']}")
    require(min(cos["mxfp8"]) >= 0.99, f"mxfp8 gradients too far from the exact STE: {cos['mxfp8']}")
    del grads

    step_ms, trajectories = {}, {}
    for mode in L.GRAD_MODES:
        mlp.load_state_dict(init)
        mlp.set_grad_mode(mode)
        opt = torch.optim.Adam(mlp.parameters(), lr=lr)
        losses, times = [], []
        for i in range(QAT_STEPS):
            t0 = time.perf_counter()
            loss = loss_of(i)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.item())       # waits for the step
            times.append((time.perf_counter() - t0) * 1e3)
        trajectories[mode] = losses
        step_ms[mode] = sum(times[1:]) / (QAT_STEPS - 1)
        print(f"phase 6 grad_mode={mode}: {step_ms[mode]:.2f} ms/step (host clock, mean of steps "
              f"2-{QAT_STEPS}; step 1 {times[0]:.1f} ms); losses {[round(v, 5) for v in losses]}")
    counts_train = dict(dispatch.launch_counts)
    trained = {k: v.detach().clone() for k, v in mlp.state_dict().items()}   # for phase 8
    for mode, losses in trajectories.items():        # every mode's trajectory is printed first
        require(all(map(math.isfinite, losses)), f"{mode}: non-finite loss {losses}")
        require(losses[-1] < losses[0], f"{mode}: loss did not fall at lr {lr}: {losses}")

    # the same MLP in plain bf16 autograd, for scale
    w1 = init["fc1.weight"].clone().requires_grad_()
    w2 = init["fc2.weight"].clone().requires_grad_()
    opt = torch.optim.Adam([w1, w2], lr=lr)
    times = []
    for i in range(QAT_STEPS):
        t0 = time.perf_counter()
        y = F.silu((xs[i] @ w1.T).float()).to(torch.bfloat16) @ w2.T
        loss = ((y.float() - targets[i]) ** 2).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        loss.item()
        times.append((time.perf_counter() - t0) * 1e3)
    plain_ms = sum(times[1:]) / (QAT_STEPS - 1)
    print(f"phase 6 plain bf16 MLP (no quantization): {plain_ms:.2f} ms/step; quantized steps "
          + ", ".join(f"{m} {step_ms[m] / plain_ms:.2f}x" for m in L.GRAD_MODES))

    # the reference's byte-level backward flow on layer 1, held against the
    # mxfp8 mode's contractions (before the clip mask and the unrotation)
    mlp.load_state_dict(init)
    mlp.set_grad_mode("mxfp8")
    x, w, h = xs[0], mlp.fc1.weight.detach(), mlp.fc1.h
    y1 = mlp.fc1(x)
    y1.retain_grad()
    y = mlp.fc2(F.silu(y1.float()).to(torch.bfloat16))
    ((y.float() - targets[0]) ** 2).mean().backward()
    dy = y1.grad
    res = L.quartet_forward(x, w, h, "quest")[1]
    dxh, dwh = L.quartet_grads_planes(res, dy, "quest", "mxfp8")
    gq, g_rs, g_cs = qt.backward_bf16_square_double_mxfp8(dy)           # K9
    wq, ws = qt.fusedQuantizeMx(w, h, method="quest")                     # K1, row-major
    w8, w8s = qt.mxfp4_transpose_mxfp8(wq, ws)                            # K10
    dxh_ref = qt.matmul_mxf8_bf16_tn(gq, w8, g_rs, w8s, 1.0)             # K11
    xq, xsc = qt.fusedQuantizeMx(x, h, method="quest")
    x8, x8s = qt.mxfp4_transpose_mxfp8(xq, xsc)                           # K10
    dwh_ref = qt.matmul_mxf8_bf16_nn(gq, x8, g_cs, x8s, 1.0)             # K11
    torch.cuda.synchronize()
    counts = dict(dispatch.launch_counts)
    flow = {k: counts[k] - counts_train[k] for k in counts}
    cx, cw = cosine(dxh_ref, _planes_to_natural(dxh)), cosine(dwh_ref, _planes_to_natural(dwh))
    print(f"phase 6 byte-level flow (K9, K10, K11) vs the mxfp8 mode's contractions: dXh cosine "
          f"{cx:.6f}, dWh cosine {cw:.6f}")
    require(min(cx, cw) >= 0.99, f"byte-level flow disagrees with the mxfp8 mode: {cx}, {cw}")
    print(f"phase 6 peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
          f"launch counts {counts} (byte-level flow {flow})")
    for name in ("quantize_mx", "gemm_int8_rank1", "square_double_scaled"):
        require(counts_train[name] > 0, f"kernel {name} was not launched by the training steps")
    for name in ("square_double_mxfp8", "mxfp4_transpose_mxfp8", "gemm_fp8_mx"):
        require(flow[name] > 0, f"kernel {name} was not launched by the byte-level flow")
    return counts, dict(x=x, w=w, h=h, dy=dy, dxh_ref=dxh_ref, dwh_ref=dwh_ref), trained


# ---------------------------------------------------------------------------
# phase 7: the Quartet backward-operand ops at Qwen3-8B MLP width
# ---------------------------------------------------------------------------

def _largest_rel_err(got, ref) -> float:
    """max |got - ref| / |ref| over the elements with |ref| >= 1e-3 max|ref|."""
    g, r = got.float(), ref.float()
    big = r.abs() >= 1e-3 * r.abs().max()
    return ((g - r).abs()[big] / r.abs()[big]).max().item()


def backward_ops(torch, ops: dict) -> dict:
    """Phase 7 on layer 1 of phase 6's MLP at its initial weights: (a)
    tests/test_linear.py's natural-order golden of the bf16 grad mode at
    full width through K15 against quartet_linear's autograd dX and dW;
    (b) the reference backward flow of qutlass_tpu/nn/linear.py (K1
    row-major, K8, K14, bf16 products) against phase 6's byte-level flow
    (K9, K10, K11); (c) SURVEY.md 3.4's wgrad operands through K12 and
    K13, multiplied by K4.  Returns the phase's launch counts."""
    import qutlass_tpu_torch as qt
    from qutlass_tpu_torch.nn import linear as L
    from qutlass_tpu_torch.ops import dispatch
    from qutlass_tpu_torch.ops import emulation as E

    x, w, h, dy = ops["x"], ops["w"], ops["h"], ops["dy"]
    m, k = x.shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()

    # (a) the natural-order golden: K15 turns the forward's K-major operands
    # into exact bf16 [K, rows]
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    L.quartet_linear(xr, wr, h, "quest", "bf16").backward(dy)
    xqt, xst, mask_t = qt.fusedQuantizeMx(x, h, method="quest", return_mask=True,
                                          layout="kmajor")
    wqt, wst = qt.fusedQuantizeMx(w, h, method="quest", layout="kmajor")
    wdq = qt.mxfp4_transpose_scaled_kmajor(wqt, wst)                    # K15, [K, N]
    xdq = qt.mxfp4_transpose_scaled_kmajor(xqt, xst)                    # K15, [K, M]
    dxh = L._bf16_matmul(dy, wdq.T) * L._unpack_mask_bits(mask_t.T, k).to(torch.bfloat16)
    rx, rw = L._unrotate(dxh, h), L._unrotate(L._bf16_matmul(dy.T, xdq.T), h)
    ca = (cosine(xr.grad, rx), cosine(wr.grad, rw))
    ea = (_largest_rel_err(xr.grad, rx), _largest_rel_err(wr.grad, rw))
    print(f"phase 7 (a) bf16 grad mode vs the natural-order golden through K15: cosine dX "
          f"{ca[0]:.6f}, dW {ca[1]:.6f}; largest relative error (|ref| >= 1e-3 max) dX "
          f"{ea[0]:.3e}, dW {ea[1]:.3e}")
    del xr, wr, wdq, xdq, dxh, rx, rw

    # (b) the reference backward flow: the primed operands pre-decoded to bf16
    gq = qt.backward_square_double_scaled(dy)                            # K8
    wq, ws = qt.fusedQuantizeMx(w, h, method="quest")                    # K1, row-major
    xq, xs = qt.fusedQuantizeMx(x, h, method="quest")
    w8, x8 = qt.mxfp4_transpose_scaled(wq, ws), qt.mxfp4_transpose_scaled(xq, xs)   # K14
    cb = (cosine(L._bf16_matmul(gq, w8.T), ops["dxh_ref"]),
          cosine(L._bf16_matmul(gq.T, x8.T), ops["dwh_ref"]))
    print(f"phase 7 (b) reference backward flow (K8, K14, bf16 products) vs the byte-level "
          f"flow (K9, K10, K11): cosine dXh {cb[0]:.6f}, dWh {cb[1]:.6f}")
    del gq, w8, x8

    # (c) the wgrad operands: each operand's codes carry the abs-max 3x, and
    # K13 (alpha 3) of x's abs-max MXFP4, whose decode is 3x, carries 3x
    # too (its plain version: byte = pow2floor(amax / 3), values times
    # 3 / (3 * scale)); so the GEMM's alpha is 1/9 in both products
    a, a_s = qt.backward_t_bf16(dy, h)                                   # K12, [N, M/2]
    b, b_s = qt.backward_t_bf16(x, h)                                    # K12, [K, M/2]
    xa, xas = qt.fusedQuantizeMx(x, h, method="abs_max")                 # K1
    bq, bq_s = qt.backward_qt_bf16(xa, xas, h, 3.0)                      # K13, [K, M/2]
    dqx = E.dequant_fp4(E.unpack_codes(xa), xas[:m, :k // 32]).float() / 3.0
    dyt = dy.float().T
    cc = []
    for tag, (bb, bs), ref in (("K12 x K12 vs dY^T x", (b, b_s), dyt @ x.float()),
                               ("K12 x K13 vs dY^T dq(x)", (bq, bq_s), dyt @ dqx)):
        got = qt.matmul_mxf4_bf16_tn(a, bb, a_s, bs, 1.0 / 9.0).float()  # K4
        cos, ratio = cosine(got, ref), (got.norm() / ref.norm()).item()
        cc.append((cos, ratio))
        print(f"phase 7 (c) wgrad {tag}: cosine {cos:.6f}, norm ratio {ratio:.6f}")
        del got, ref
    torch.cuda.synchronize()
    counts = dict(dispatch.launch_counts)
    print(f"phase 7 in {time.perf_counter() - t0:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launch counts {counts}")
    require(min(ca) >= 0.9999, f"(a) bf16 grad mode vs the natural-order golden: {ca}")
    require(min(cb) >= 0.9999, f"(b) reference flow vs the byte-level flow: {cb}")
    for cos, ratio in cc:
        require(cos >= 0.95 and 0.9 <= ratio <= 1.1,
                f"(c) wgrad operands: cosine {cos}, norm ratio {ratio}")
    for name in BWD_OPS:
        require(counts[name] > 0, f"kernel {name} was not launched by phase 7")
    return counts


# ---------------------------------------------------------------------------
# phase 8: the single-kernel quantized linear at Qwen3-8B MLP width
# ---------------------------------------------------------------------------

SWITCH = "QUTLASS_TPU_FUSED_LINEAR"
FL_TOKENS, FL_NV_TOKENS = (4, 64, 4096), (4, 64)


def fused_linear_phase(torch, trained) -> dict:
    """Phase 8: the QAT MLP of phase 6 at its trained weights (seeded ones
    when ``trained`` is None) in eval mode, and one abs-max QuartetLinear
    with its first layer's weight, through ``fused_linear_mxf4`` with the
    switch unset (K1 + K4) and set (K16); Qwen3-8B's gate and down
    projections as NVFP4 fp4-stored weights through ``fused_linear_nvf4``
    (K5 + K7, K17).  Each route's run is counted on its own: the two give
    the same bits, the single kernel launches and the composition's
    kernels do not (the weight's K1 aside); both are timed (CUDA events).
    Returns the launch counts summed over the counted runs."""
    import torch.nn.functional as F
    import qutlass_tpu_torch as qt
    from qutlass_tpu_torch.nn import linear as L
    from qutlass_tpu_torch.ops import dispatch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    h = qt.hadamard_matrix(ROT, device=dev)
    total = {name: 0 for name in dispatch.KERNELS}

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    def set_switch(value):
        if value is None:
            os.environ.pop(SWITCH, None)
        else:
            os.environ[SWITCH] = value

    def run(value, fn):
        set_switch(value)
        dispatch.reset_launch_counts()
        with torch.no_grad():
            y = fn()
        torch.cuda.synchronize()
        counts = dict(dispatch.launch_counts)
        for name, n in counts.items():
            total[name] += n
        return y, counts

    def both_routes(tag, fn, single, comp, iters=10):
        """Run and time fn under each route; require equal bits and the
        launch counts ``single`` / ``comp`` (kernel: count) of each run."""
        (yc, cc), (yf, cf) = run(None, fn), run("1", fn)
        for counts, want, route in ((cf, single, "single kernel"), (cc, comp, "composition")):
            got = {name: counts[name] for name in want}
            require(got == want, f"phase 8 {tag}: {route} launch counts {got}, expected {want}")
        require(torch.equal(yc, yf), f"phase 8 {tag}: the routes differ in "
                                     f"{int((yc != yf).sum())} outputs")
        with torch.no_grad():
            set_switch(None)
            ms_c = timed_ms(torch, fn, iters)
            set_switch("1")
            ms_f = timed_ms(torch, fn, iters)
        return yf, ms_c, ms_f

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    old, t0 = os.environ.get(SWITCH), time.perf_counter()
    try:
        mlp = L.QuartetMLP(QAT_D, QAT_H, QAT_D, rot_size=ROT, method="quest", device=dev,
                           generator=gen)
        if trained is not None:
            mlp.load_state_dict(trained)
        mlp.eval()
        w1, w2 = mlp.fc1.weight.detach(), mlp.fc2.weight.detach()
        for m in FL_TOKENS:
            x = randn(m, QAT_D)
            # per layer: K1 on the weight (both routes) and on x, then K4; or K16
            y, ms_c, ms_f = both_routes(
                f"QuartetMLP M={m}", lambda: mlp(x),
                {"fused_linear_mx": 2, "quantize_mx": 2, "gemm_fp4_mx": 0},
                {"fused_linear_mx": 0, "quantize_mx": 4, "gemm_fp4_mx": 2,
                 "gemm_fp4_mx_decode": 2 if m <= 16 else 0,
                 "gemm_fp4_mx_prefill": 0 if m <= 16 else 2},
                iters=3 if m > 64 else 10)
            ref = F.silu((x @ w1.T).float()).to(torch.bfloat16) @ w2.T
            cos = cosine(y, ref)
            # two W4A4 layers of random weights: 0.953 on the CPU at this width
            # and seeded weights (one layer 0.974), so this bounds gross faults
            require(bool(torch.isfinite(y).all()) and cos >= 0.9,
                    f"phase 8 QuartetMLP M={m}: cosine {cos} to the bf16 MLP")
            print(f"phase 8 MX QuartetMLP eval {QAT_D}->{QAT_H}->{QAT_D} M={m}: composition "
                  f"(K1 + K4) {ms_c:.4f} ms, single kernel (K16) {ms_f:.4f} ms, bitwise equal; "
                  f"output cosine to the bf16 MLP {cos:.6f}")
        lin = L.QuartetLinear(QAT_D, QAT_H, rot_size=ROT, method="abs_max", device=dev)
        with torch.no_grad():
            lin.weight.copy_(w1)
        lin.eval()
        x = randn(64, QAT_D)
        y, ms_c, ms_f = both_routes(
            "abs-max QuartetLinear M=64", lambda: lin(x),
            {"fused_linear_mx": 1, "quantize_mx": 1, "gemm_fp4_mx": 0},
            {"fused_linear_mx": 0, "quantize_mx": 2, "gemm_fp4_mx": 1, "gemm_fp4_mx_prefill": 1})
        cos = cosine(y, x @ w1.T)
        require(cos >= 0.95, f"phase 8 abs-max QuartetLinear: cosine {cos} to the bf16 linear")
        print(f"phase 8 MX abs-max QuartetLinear eval {QAT_D}->{QAT_H} M=64 (alpha 1/9): "
              f"composition {ms_c:.4f} ms, K16 {ms_f:.4f} ms, bitwise equal; cosine {cos:.6f}")
        del mlp, lin, w1, w2

        # NVFP4: Qwen3-8B's gate and down projections, fp4-stored as
        # quantize_weight(fmt="nv") stores them; the activation's exact
        # global scale and alpha = 1/(gsx*gs), as nv_linear forms them
        for tag, (k, n) in (("gate", (QAT_D, QAT_H)), ("down", (QAT_H, QAT_D))):
            w = randn(n, k, scale=k ** -0.5)
            wq = L.quantize_weight(w, h=h, fmt="nv", weight_format="fp4")
            for m in FL_NV_TOKENS:
                x = randn(m, k)
                gsx = L.nv_global_scale(L.rotated_amax(x, h))
                alpha = 1.0 / (gsx * wq["gs"])
                y, ms_c, ms_f = both_routes(
                    f"NV {tag} M={m}",
                    lambda: qt.fused_linear_nvf4(x, wq["wqt"], wq["wst"], h, gsx, alpha),
                    {"fused_linear_nv": 1, "quantize_nv": 0, "gemm_fp4_nv": 0},
                    {"fused_linear_nv": 0, "quantize_nv": 1, "gemm_fp4_nv": 1})
                cos = cosine(y, x @ w.T)
                require(cos >= 0.95, f"phase 8 NV {tag} M={m}: cosine {cos} to the bf16 linear")
                print(f"phase 8 NV {tag} {k}->{n} M={m}: composition (K5 + K7) {ms_c:.4f} ms, "
                      f"single kernel (K17) {ms_f:.4f} ms, bitwise equal; cosine to the bf16 "
                      f"linear {cos:.6f}")
    finally:
        set_switch(old)
    print(f"phase 8 in {time.perf_counter() - t0:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launch counts of the counted "
          f"runs {total}")
    for name in ("fused_linear_mx", "fused_linear_nv"):
        require(total[name] > 0, f"kernel {name} was not launched by phase 8")
    return total


LFM2_LAYERS = 6                 # phase 9's depth: 2 dense layers, then 4 expert layers
LFM2_LENS = [256, 200, 160, 128, 96, 64, 17, 2]   # 2 is shorter than the conv window
LFM2_STEPS = 16


def serve_lfm2(torch) -> dict:
    """Phase 9, LFM2-24B-A2B at its published widths, cut to its first
    ``LFM2_LAYERS`` layers (short conv, attention at layer 2, K18 in the
    expert layers): seeded weights quantized on the card, a ragged
    prefill of 8 prompts, then ``LFM2_STEPS`` decode steps through the
    decode graph (one capture, replays after) with the routing counters
    on; K18's launches and the counters against the routing, and the
    steps' logits bit for bit against the eager body on a second cache.
    Returns the launch counts of the graphed run."""
    import qutlass_tpu_torch as qt
    from qutlass_tpu_torch import models as M
    from qutlass_tpu_torch.models import experts as X
    from qutlass_tpu_torch.models import serving as S
    from qutlass_tpu_torch.ops import dispatch

    base = M.LFM2_24B_A2B
    cfg = dataclasses.replace(base, num_layers=LFM2_LAYERS,
                              layer_types=base.layer_types[:LFM2_LAYERS])
    moe_layers = sum(cfg.has_experts(i) for i in range(cfg.num_layers))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    h = qt.hadamard_matrix(ROT, device=dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, gen, device=dev)
    qp = M.quantize_model_weights(cfg, params, h, weight_format="fp4")
    del params
    X.count_routes(qp)
    load_ms = sync_ms(torch, t0)
    b, t = len(LFM2_LENS), max(LFM2_LENS)
    lengths = torch.tensor(LFM2_LENS, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (b, t), generator=gen, device=dev)
    prompt = prompt.masked_fill(torch.arange(t, device=dev)[None] >= lengths[:, None], 0)
    max_len = t + LFM2_STEPS

    def run(decode):
        logits, cache = M.prefill(cfg, qp, prompt, h, max_len=max_len, quantized=True,
                                  lengths=lengths)
        tok, pos, out, times = logits.argmax(-1), lengths.clone(), [], []
        for _ in range(LFM2_STEPS):
            t1 = time.perf_counter()
            logits, cache = decode(cfg, qp, cache, tok, pos, h, quantized=True)
            times.append(sync_ms(torch, t1))
            out.append(logits)
            tok, pos = logits.argmax(-1), pos + 1
        return out, times, cache

    def eager(cfg, params, cache, tok, pos, h, quantized):
        return S._decode(cfg, params, cache, tok, pos, h, quantized, "quest"), cache

    dispatch.reset_launch_counts()
    graphed, times, cache = run(M.decode_step)
    torch.cuda.synchronize()
    counts = dict(dispatch.launch_counts)
    routed = torch.stack([layer["route_counts"] for layer in qp["layers"] if "router" in layer])
    routed = routed.cpu()
    want = 3 * moe_layers * LFM2_STEPS
    require(counts["gemm_fp4_experts"] == want,
            f"phase 9: K18 launched {counts['gemm_fp4_experts']} times, expected {want}")
    require(S._GRAPHS.get(S._first_state(cache)) is not None, "phase 9: no decode graph")
    require(routed[:, 0].sum(-1).tolist() == [b * cfg.experts_per_token * LFM2_STEPS] * moe_layers,
            f"phase 9: routing counters count {routed[:, 0].sum(-1).tolist()} rows")
    require(bool((routed[:, 1] <= LFM2_STEPS).all()) and bool((routed[:, 1] <= routed[:, 0]).all()),
            "phase 9: a routing counter's active calls exceed its steps or rows")
    plain, _, _ = run(eager)
    for s_, (a, c) in enumerate(zip(graphed, plain)):
        require(torch.equal(a, c), f"phase 9: replayed step {s_} differs from the eager body")
    require(all(bool(torch.isfinite(a).all()) for a in graphed), "phase 9: non-finite logits")
    active = routed[:, 1].sum().item() / (moe_layers * LFM2_STEPS)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"phase 9 LFM2-24B-A2B, {LFM2_LAYERS} of {base.num_layers} layers at full width "
          f"({moe_layers} expert layers): weights drawn and quantized in {load_ms:.0f} ms; "
          f"ragged prefill of {LFM2_LENS}, {LFM2_STEPS} decode steps through the decode graph, "
          f"bitwise the eager body; K18 launches {counts['gemm_fp4_experts']} "
          f"(3 a layer a step); {active:.2f} of {cfg.num_experts} experts active a layer a step; "
          f"replayed steps {min(times[1:]):.2f}-{max(times[1:]):.2f} ms on the host clock "
          f"(capture step {times[0]:.1f} ms); peak device memory {peak_gib:.2f} GiB")
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=36)
    ap.add_argument("--qat-lr", type=float, default=QAT_LR)
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
                      "launches": 0, "max_abs_err": 0.0, "ms": None, "plain_ms": None,
                      "bound_ms": None, "bound_by": None, "library_ms": None}
               for name, (src, rep) in KERNELS.items()}
    qtimes, ktimes = {}, {}
    compare_kernels(torch, results, qtimes, ktimes)
    compare_k4_prefill_kernels(torch)
    compare_nv_kernels(torch, results, qtimes, ktimes)
    compare_qat_kernels(torch, results)
    compare_bwd_op_kernels(torch, results)
    compare_fused_linear_kernels(torch, results)
    compare_experts_kernel(torch, results)
    from qutlass_tpu_torch.models import QWEN3_8B
    compare_k3(torch, results, QWEN3_8B.num_layers)
    quantizer_sums(torch, qtimes, QWEN3_8B.num_layers)
    fp4_sums(torch, ktimes, QWEN3_8B.num_layers)

    # phase 3
    t0 = time.perf_counter()
    test = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-q",
                           "-p", "no:cacheprovider", "-W",
                           "ignore::pytest.PytestUnknownMarkWarning",
                           "tests/test_torch_gpu.py", "tests/test_torch_decode_graph.py",
                           "tests/test_torch_lfm2_moe.py", "tests/test_torch_kv_cache.py"],
                          cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    tail = test.stdout.strip().splitlines()[-1:] or [""]
    print(f"phase 3 gpu tests ({time.perf_counter() - t0:.0f} s): {tail[0]}")
    require(test.returncode == 0, f"gpu tests failed:\n{test.stdout[-6000:]}\n{test.stderr[-2000:]}")

    # phases 4-8; K1, K3 and K4 run on several paths, and their launches
    # are the sum
    counts = serve(torch, args.layers, STEPS)
    for name in MX_PATH:
        results[name]["launches"] += counts[name]
    counts = serve_nv(torch, args.layers, STEPS)
    for name in NV_PATH:
        results[name]["launches"] += counts[name]
    # phase 6
    counts, layer1, trained = train_qat(torch, args.qat_lr)
    for name in QAT_PATH:
        results[name]["launches"] += counts[name]
    # phase 7: every kernel it launched counts
    for name, n in backward_ops(torch, layer1).items():
        results[name]["launches"] += n
    del layer1
    # phase 8: every kernel its counted runs launched counts
    for name, n in fused_linear_phase(torch, trained).items():
        results[name]["launches"] += n
    # phase 9: every kernel of its graphed run counts
    for name, n in serve_lfm2(torch).items():
        results[name]["launches"] += n

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
