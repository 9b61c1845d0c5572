"""The host side of the program's ``qt.*`` spans in a ``Trace``, and the
per-layer readers that take it."""
import pytest

from port_bench.lib import harness as H
from port_bench.lib import spans as S
from port_bench.lib import trace as T

SPEC = H.load_json(H.ROOT / "BENCHMARK.json")
SPAN_METRICS = [m["name"] for m in SPEC["per_layer"] if m["source"] == "program_span"]


def reader(name):
    return H.load_module(H.BENCH / "metrics" / f"{name}.py", "s_" + name.replace(".", "_"))


def decode_trace(units=2):
    """Two decode steps' worth of host ranges in the stretch [0, 100]:
    qt.decode_step > qt.linear > aten::add, and the benchmark's own spans
    around them."""
    host = [(T.STRETCH, 0, 100), ("bench.decode_step", 0, 91), ("qt.decode_step", 1, 90),
            ("qt.linear", 10, 60), ("aten::add", 40, 50), ("bench.token_copy", 92, 99),
            ("cudaLaunchKernel", 42, 44)]
    return T.Trace(device=[("k", 20, 30)], host=host, start_us=0, end_us=100, units=units)


def test_the_host_parts_of_the_spans():
    assert S.from_trace(decode_trace()) == {
        "qt.decode_step": {"count": 1, "host_us": 89}, "qt.linear": {"count": 1, "host_us": 50}}
    tr = decode_trace()
    tr.host.append(("qt.linear", 61, 71))
    assert S.from_trace(tr)["qt.linear"] == {"count": 2, "host_us": 60}
    assert S.host_ms(tr, "qt.linear") == pytest.approx(0.03)
    assert S.host_ms(tr, "qt.attend") is None
    assert S.from_trace(T.Trace(device=[], host=[(T.STRETCH, 0, 1)], start_us=0,
                                end_us=1)) is None
    assert S.from_trace(None) is None and S.host_ms(None, "qt.linear") is None


def test_a_profile_keeps_the_spans():
    """``from_profiler`` keeps the spans among the host operations, and
    drops their mirrors on the device's timeline."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    def ev(name, s, e, dev=DeviceType.CPU, ann=False):
        return NS(name=name, time_range=NS(start=s, end=e), device_type=dev,
                  is_user_annotation=ann)
    events = [ev(T.STRETCH, 0, 100), ev("qt.decode_step", 1, 90), ev("qt.linear", 10, 60),
              ev("qt.linear", 20, 75, DeviceType.CUDA, True), ev("void k(...)", 20, 30,
                                                                  DeviceType.CUDA)]
    tr = T.from_profiler(NS(events=lambda: events), 1, {})
    assert [op[0] for op in tr.device] == ["void k(...)"]
    assert S.from_trace(tr) == {"qt.decode_step": {"count": 1, "host_us": 89},
                                "qt.linear": {"count": 1, "host_us": 50}}


def test_decode_readers():
    tr = decode_trace()
    ctx = {"trace": tr, "work": {}}
    # per step of two: qt.decode_step 89 us, qt.linear 50
    assert reader("linear_host_ms.decode").read(ctx) == pytest.approx(0.025)
    assert reader("glue_host_ms.decode").read(ctx) == pytest.approx(0.0195)
    tr.host.append(("qt.attend", 61, 71))
    assert reader("glue_host_ms.decode").read(ctx) == pytest.approx(0.0145)


def test_prefill_reader():
    host = [(T.STRETCH, 0, 1000), ("bench.prefill", 0, 900), ("qt.prefill", 10, 890),
            ("qt.rope", 100, 300), ("qt.rope", 400, 420), ("cudaMemcpyAsync", 110, 290)]
    tr = T.Trace(device=[("k", 0, 5)], host=host, start_us=0, end_us=1000, units=1,
                 work={"prompt_tokens": 100})
    assert reader("rope_host_pct.prefill").read({"trace": tr, "work": {}}) == pytest.approx(25.0)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_readers_return_nothing_without_spans(name):
    """The parent program has no qt.* span: its trace reads nothing."""
    bare = T.Trace(device=[("k", 1, 2)], host=[(T.STRETCH, 0, 10), ("cudaLaunchKernel", 0, 1)],
                   start_us=0, end_us=10, units=1, work={"prompt_tokens": 100})
    assert reader(name).read({"trace": bare, "work": {}}) is None
    assert reader(name).read({"trace": None, "work": {}}) is None
