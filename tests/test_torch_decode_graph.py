"""The ragged decode step as one CUDA graph of its KV cache
(``models.serving.decode_step``).  On the card (marked ``gpu``; they skip
without a CUDA device and run on the H100 through ``chip_smoke.py``):
every step's logits and the final cache bitwise the eager step's on each
route, one capture a cache and replays after it, launch counts as an
eager step's, no host sync, capture under a recording profiler.  On the
CPU: RoPE's cached table has the per-call expression's bits, and the step
runs eagerly, with no graph.  This file imports no JAX."""
import collections
import gc
import weakref

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import qutlass_tpu_torch as qt
from qutlass_tpu_torch import models as M
from qutlass_tpu_torch.models import serving as S
from qutlass_tpu_torch.models import transformer as TF
from qutlass_tpu_torch.ops import dispatch
import torch_helpers  # noqa: F401  (the worker's thread budget)

CFG = M.tiny_config()
LENS = [8, 5, 3]
STEPS = 6
MAX_LEN = max(LENS) + STEPS
# route -> (format, weight storage), None for the unquantized model
ROUTES = {"mx_fp4": ("mx", "fp4"), "mx_int8": ("mx", "int8"), "nv_fp4": ("nv", "fp4"),
          "nv_int8": ("nv", "int8"), "bf16": None}


def model(dev, route):
    params = M.init_params(CFG, torch.Generator(device=dev).manual_seed(0), device=dev)
    h = qt.hadamard_matrix(32, device=dev)
    if ROUTES[route] is None:
        return params, h, False
    fmt, storage = ROUTES[route]
    return M.quantize_model_weights(CFG, params, h, fmt=fmt, weight_format=storage), h, True


def prefilled(dev, params, h, quantized, ragged=True):
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, CFG.vocab_size, (len(LENS), max(LENS)), generator=g, device=dev)
    lens = torch.tensor(LENS, device=dev) if ragged else None
    logits, cache = M.prefill(CFG, params, toks, h, max_len=MAX_LEN, quantized=quantized,
                              lengths=lens)
    return logits, cache, lens


@torch.no_grad()
def eager(params, cache, tok, pos, h, quantized):
    return S._decode(CFG, params, cache, tok, pos, h, quantized, "quest")


def graph_spans(prof):
    """The graph spans on the host (a profile of the card mirrors them there)."""
    return collections.Counter(ev.name for ev in prof.events()
                               if ev.name in ("qt.graph_capture", "qt.graph_replay")
                               and ev.device_type == DeviceType.CPU)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("route", list(ROUTES))
def test_replay_is_the_eager_step_bit_for_bit(dev, route):
    """Six ragged steps through ``decode_step`` against the eager body on a
    second cache: the same logits and cache bits, one capture, five
    replays, on every route of the projections."""
    params, h, quantized = model(dev, route)
    logits, cache, lens = prefilled(dev, params, h, quantized)
    logits_e, cache_e, _ = prefilled(dev, params, h, quantized)
    assert torch.equal(logits, logits_e)
    tok, pos = logits.argmax(-1), lens.clone()
    outs = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(STEPS):
            out, cache = M.decode_step(CFG, params, cache, tok, pos, h, quantized=quantized)
            outs.append((out, eager(params, cache_e, tok, pos, h, quantized)))
            tok, pos = out.argmax(-1), pos + 1
    for out, ref in outs:
        assert torch.equal(out, ref)
    assert all(torch.equal(c[n], ce[n]) for c, ce in zip(cache, cache_e) for n in ("k", "v"))
    assert graph_spans(prof) == {"qt.graph_capture": 1, "qt.graph_replay": STEPS - 1}


@pytest.mark.gpu
def test_an_int_position_stays_eager(dev):
    params, h, quantized = model(dev, "mx_fp4")
    logits, cache, _ = prefilled(dev, params, h, quantized, ragged=False)
    _, cache_e, _ = prefilled(dev, params, h, quantized, ragged=False)
    tok = logits.argmax(-1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for p in range(max(LENS), max(LENS) + 2):
            out, cache = M.decode_step(CFG, params, cache, tok, p, h, quantized=True)
            assert torch.equal(out, eager(params, cache_e, tok, p, h, True))
            tok = out.argmax(-1)
    assert cache[0]["k"] not in S._GRAPHS
    assert not graph_spans(prof)


@pytest.mark.gpu
def test_a_new_cache_captures_anew_and_the_old_graph_goes_with_its_cache(dev):
    params, h, quantized = model(dev, "mx_fp4")
    graphs = []
    caches = []
    for _ in range(2):
        logits, cache, lens = prefilled(dev, params, h, quantized)
        tok, pos = logits.argmax(-1), lens.clone()
        for _ in range(2):
            out, cache = M.decode_step(CFG, params, cache, tok, pos, h, quantized=True)
            tok, pos = out.argmax(-1), pos + 1
        graphs.append(weakref.ref(S._GRAPHS[cache[0]["k"]]))
        caches.append(cache)
    assert graphs[0]() is not graphs[1]() and graphs[0]().graph is not graphs[1]().graph
    # positions of another dtype on the same cache capture anew too
    M.decode_step(CFG, params, caches[1], tok, pos.to(torch.int32), h, quantized=True)
    assert S._GRAPHS[caches[1][0]["k"]] is not graphs[1]()
    del caches[0], cache
    gc.collect()
    assert graphs[0]() is None and len(caches) == 1


@pytest.mark.gpu
def test_a_replay_counts_the_launches_of_an_eager_step(dev):
    params, h, quantized = model(dev, "mx_fp4")
    logits, cache, lens = prefilled(dev, params, h, quantized)
    _, cache_e, _ = prefilled(dev, params, h, quantized)
    tok, pos = logits.argmax(-1), lens.clone()

    def moved(fn):
        before = dict(dispatch.launch_counts)
        out = fn()
        return out, {k: n - before[k] for k, n in dispatch.launch_counts.items() if n != before[k]}
    (out, cache), capture = moved(lambda: M.decode_step(CFG, params, cache, tok, pos, h,
                                                        quantized=True))
    _, first = moved(lambda: eager(params, cache_e, tok, pos, h, True))
    tok, pos = out.argmax(-1), pos + 1
    (out, cache), replay = moved(lambda: M.decode_step(CFG, params, cache, tok, pos, h,
                                                       quantized=True))
    _, second = moved(lambda: eager(params, cache_e, tok, pos, h, True))
    assert first and capture == first and replay == second == first
    assert replay["gemm_fp4_mx_decode"] == 7 * CFG.num_layers


@pytest.mark.gpu
def test_the_ragged_step_makes_no_host_sync(dev):
    """Capture, replays and the eager body under sync-debug "error": the
    step waits for the card nowhere (prefill, outside, builds RoPE's table)."""
    params, h, quantized = model(dev, "mx_fp4")
    logits, cache, lens = prefilled(dev, params, h, quantized)
    _, cache_e, _ = prefilled(dev, params, h, quantized)
    tok, pos = logits.argmax(-1), lens.clone()
    outs = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(STEPS):
            out, cache = M.decode_step(CFG, params, cache, tok, pos, h, quantized=True)
            outs.append((out, eager(params, cache_e, tok, pos, h, True)))
            tok, pos = out.argmax(-1), pos + 1
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(torch.equal(out, ref) for out, ref in outs)


@pytest.mark.gpu
def test_capture_and_replay_under_a_recording_profiler(dev):
    """With the card's activity traced, as the benchmark's traced stretch
    does: the same bits, and every replayed kernel on the device's
    timeline (K4's decode kernel once a linear a step)."""
    params, h, quantized = model(dev, "mx_fp4")
    logits, cache, lens = prefilled(dev, params, h, quantized)
    _, cache_e, _ = prefilled(dev, params, h, quantized)
    tok, pos = logits.argmax(-1), lens.clone()
    outs = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(STEPS):
            out, cache = M.decode_step(CFG, params, cache, tok, pos, h, quantized=True)
            tok, pos = out.argmax(-1), pos + 1
            outs.append(out)
        torch.cuda.synchronize()
    tok, pos = logits.argmax(-1), lens.clone()
    for out in outs:
        assert torch.equal(out, eager(params, cache_e, tok, pos, h, True))
        tok, pos = out.argmax(-1), pos + 1
    assert graph_spans(prof) == {"qt.graph_capture": 1, "qt.graph_replay": STEPS - 1}
    k4 = [ev for ev in prof.events()
          if ev.device_type == DeviceType.CUDA and "gemm_fp4_decode" in ev.name]
    assert len(k4) == 7 * CFG.num_layers * STEPS


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_table_has_the_per_call_bits(d, theta):
    """``_rope``'s table, built once per (head size, theta, device), is the
    per-call expression it replaced, bit for bit, and so is the rotation."""
    old = torch.tensor(1.0 / (theta ** (np.arange(0, d, 2) / d)), dtype=torch.float32)
    table = TF._rope_inv_freq(d, theta, torch.device("cpu"))
    assert torch.equal(table.view(torch.int32), old.view(torch.int32))
    assert TF._rope_inv_freq(d, theta, torch.device("cpu")) is table
    x = torch.randn((2, 3, 4, d), generator=torch.Generator().manual_seed(d)).to(torch.bfloat16)
    positions = torch.tensor([[7, 8, 9], [1, 2, 3]])
    ang = positions[..., None].to(torch.float32) * old
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    want = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
    assert torch.equal(TF._rope(x, positions, theta).view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("route", ["mx_fp4", "bf16"])
def test_the_cpu_step_runs_eagerly(route):
    """On the CPU a ragged step is the eager body: no graph, no graph span."""
    params, h, quantized = model(torch.device("cpu"), route)
    logits, cache, lens = prefilled(torch.device("cpu"), params, h, quantized)
    _, cache_e, _ = prefilled(torch.device("cpu"), params, h, quantized)
    tok, pos = logits.argmax(-1), lens.clone()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            out, cache = M.decode_step(CFG, params, cache, tok, pos, h, quantized=quantized)
            assert torch.equal(out, eager(params, cache_e, tok, pos, h, quantized))
            tok, pos = out.argmax(-1), pos + 1
    assert cache[0]["k"] not in S._GRAPHS
    assert not graph_spans(prof)
    assert all(torch.equal(c[n], ce[n]) for c, ce in zip(cache, cache_e) for n in ("k", "v"))
