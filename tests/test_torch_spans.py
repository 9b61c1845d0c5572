"""The port's ``qt.*`` spans (``ops.dispatch.span``) in the serving path:
the tree a profiler records for ``prefill`` and ``decode_step`` on every
quantized-linear route, no ``record_function`` without a profiler, and
the same logits either way."""
import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import qutlass_tpu_torch as qt
from qutlass_tpu_torch import models as M
from qutlass_tpu_torch.ops import dispatch
import torch_helpers  # noqa: F401  (the worker's thread budget)

CFG = M.tiny_config()
ROUTES = {"mx_fp4": ("mx", "fp4", "wqt"), "mx_int8": ("mx", "int8", "wi8"),
          "nv_fp4": ("nv", "fp4", "wqt"), "nv_int8": ("nv", "int8", "nvi8")}


@pytest.fixture(scope="module")
def served():
    params = M.init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    h = qt.hadamard_matrix(32, device="cpu")
    out = {}
    for route, (fmt, storage, leaf) in ROUTES.items():
        qp = M.quantize_model_weights(CFG, params, h, fmt=fmt, weight_format=storage)
        assert all(leaf in layer[p] for layer in qp["layers"] for p in ("q_proj", "down_proj"))
        out[route] = qp
    toks = torch.randint(0, CFG.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1))
    return out, h, toks, torch.tensor([8, 5])


def serve(qp, h, toks, lens):
    logits, cache = M.prefill(CFG, qp, toks, h, max_len=12, quantized=True, lengths=lens)
    step, _ = M.decode_step(CFG, qp, cache, logits.argmax(-1), lens, h, quantized=True)
    return logits, step


def qt_ancestors(ev):
    """The qt.* spans around ``ev``, innermost first."""
    out, ev = [], ev.cpu_parent
    while ev is not None:
        if ev.name.startswith("qt."):
            out.append(ev)
        ev = ev.cpu_parent
    return out


@pytest.mark.parametrize("route", list(ROUTES))
def test_serving_records_the_span_tree(served, route):
    params, h, toks, lens = served
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        serve(params[route], h, toks, lens)
    events = list(prof.events())
    spans = [ev for ev in events if ev.name.startswith("qt.")]
    # each span as (name, the innermost qt.* span around it, its root)
    got = collections.Counter()
    for ev in spans:
        up = qt_ancestors(ev)
        got[ev.name, up[0].name if up else None, up[-1].name if up else ev.name] += 1
    n = CFG.num_layers
    want = collections.Counter()
    for root in ("qt.prefill", "qt.decode_step"):
        want.update({(root, None, root): 1, ("qt.attend", root, root): n,
                     ("qt.rope", root, root): 2 * n, ("qt.linear", root, root): 7 * n})
    assert got == want
    # every linear encloses operations of its own: its quantize and its GEMM
    owners = collections.Counter(id(up[0]) for up in map(qt_ancestors, events)
                                 if up and up[0].name == "qt.linear")
    assert all(owners[id(ev)] > 0 for ev in spans if ev.name == "qt.linear")


def test_no_record_function_without_a_profiler(served, monkeypatch):
    params, h, toks, lens = served

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    twice = dispatch.span("qt.x")(lambda a, b=0: (a, b))
    assert twice(1, b=2) == (1, 2)
    for qp in params.values():
        serve(qp, h, toks, lens)


def test_logits_are_the_same_bits_with_the_profiler_on(served):
    params, h, toks, lens = served
    for qp in params.values():
        off = serve(qp, h, toks, lens)
        with profile(activities=[ProfilerActivity.CPU]):
            on = serve(qp, h, toks, lens)
        for a, b in zip(off, on):
            assert torch.equal(a, b)
