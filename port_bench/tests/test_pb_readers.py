"""Each per-layer reader on a synthetic trace, and the trace reduction."""
import pytest

from port_bench import counts as C
from port_bench.lib import harness as H
from port_bench.lib import trace as T

SPEC = H.load_json(H.ROOT / "BENCHMARK.json")
QWEN = H.load_json(H.ROOT / "port_bench/configs/qwen3-8b-mxfp4.json")["model"]


def reader(name):
    return H.load_module(H.BENCH / "metrics" / f"{name}.py", "m_" + name.replace(".", "_"))


def decode_trace():
    """Two decode steps in a 1000 us stretch [100, 1100]: per step a K4
    decode kernel of 100 us, a cuBLAS head of 50 us, a copy of 10 us;
    the first step's kernels overlap by 20 us."""
    dev = [("void (anonymous namespace)::gemm_fp4_decode<dec::Mx>(...)", 100, 200),
           ("sm90_xmma_gemm_f32f32", 180, 230), ("Memcpy DtoH (Device -> Pinned)", 240, 250),
           ("void (anonymous namespace)::gemm_fp4_decode<dec::Mx>(...)", 600, 700),
           ("sm90_xmma_gemm_f32f32", 700, 750), ("Memcpy DtoH (Device -> Pinned)", 760, 770),
           ("late kernel", 1090, 1200)]
    host = [(T.STRETCH, 100, 1100), ("bench.decode_step", 100, 500),
            ("aten::mm", 300, 450), ("bench.token_copy", 500, 600), ("bench.decode_step", 600, 1000)]
    gemms = [(4, 4096, 4096), (4, 12288, 4096)]
    return T.Trace(device=dev, host=host, start_us=100, end_us=1100, units=2,
                   work={"decode_steps": 2, "gemms": gemms})


def test_union_idle_and_breakdown():
    tr = decode_trace()
    # busy: [100, 230] 130 + [240, 250] 10 + [600, 750] 150 + [760, 770] 10 + [1090, 1100] 10
    assert T.busy_s(tr) == pytest.approx(310e-6)
    assert tr.window_s == pytest.approx(1000e-6)
    gaps = T.idle_gaps(tr)
    assert gaps == [(230, 240), (250, 600), (750, 760), (770, 1090)]
    bd = T.breakdown(tr)
    assert bd["device_ops"][0][0] == "void (anonymous namespace)::gemm_fp4_decode<dec::Mx>"
    assert bd["device_ops"][0][1] == pytest.approx(200e-6)
    # the gap [250, 600] has its middle in aten::mm (300-450), the shortest open host op
    names = dict(bd["idle_gaps"])
    assert names["aten::mm"] == pytest.approx(350e-6)
    assert names["bench.decode_step"] == pytest.approx((10 + 10 + 320) * 1e-6)


def test_device_readers():
    tr = decode_trace()
    ctx = {"trace": tr, "work": {}, "model": QWEN}
    assert reader("device_idle_pct.decode").read(ctx) == pytest.approx(69.0)
    assert reader("decode_busy_ms").read(ctx) == pytest.approx(0.155)
    assert reader("kernels_per_step.decode").read(ctx) == pytest.approx(2.5)   # 5 kernels, 2 steps
    bound = C.fp4_gemm_bound_s(4, 4096, 4096) + C.fp4_gemm_bound_s(4, 12288, 4096)
    assert reader("gemm_fp4_decode_roofline").read(ctx) == pytest.approx(100 * bound / 200e-6)
    assert reader("gemm_fp4_prefill_roofline").read(ctx) is None        # no prefill kernel here


def test_prefill_readers():
    dev = [("void (anonymous namespace)::gemm_fp4_prefill<dec::Mx>(...)", 0, 400),
           ("void qf4::quantize_fp4<32, 32>(...)", 400, 450), ("elementwise_kernel", 450, 500)]
    tr = T.Trace(device=dev, host=[(T.STRETCH, 0, 1000)], start_us=0, end_us=1000, units=2,
                 work={"prompt_tokens": 2000, "gemms": [(1000, 4096, 4096)] * 2})
    ctx = {"trace": tr, "work": {}, "model": QWEN}
    assert reader("prefill_busy_ms_per_ktok").read(ctx) == pytest.approx(0.25)
    assert reader("gemm_fp4_prefill_roofline").read(ctx) == pytest.approx(
        100 * 2 * C.fp4_gemm_bound_s(1000, 4096, 4096) / 400e-6)
    assert reader("device_idle_pct.prefill").read(ctx) == pytest.approx(50.0)
    # an NVFP4 configuration's GEMMs carry a scale byte a 16-group
    tr.work["format"] = "nvfp4"
    assert reader("gemm_fp4_prefill_roofline").read(ctx) == pytest.approx(
        100 * 2 * C.fp4_gemm_bound_s(1000, 4096, 4096, 16) / 400e-6)


def test_mfu_and_host_readers():
    work = {"flops": 1979e12 * 0.05 * 10, "seconds": 10, "decode_host_s": [0.08, 0.1]}
    for kind in ("decode", "prefill"):
        assert reader(f"mfu.{kind}").read({"trace": None, "work": work}) == pytest.approx(5.0)
    assert reader("decode_host_ms").read({"trace": None, "work": work}) == pytest.approx(90.0)


def test_readers_return_nothing_without_data():
    empty = T.Trace(device=[], host=[(T.STRETCH, 0, 10)], start_us=0, end_us=10, units=1)
    for m in SPEC["per_layer"]:
        if m["source"] == "device_trace" and not m["name"].startswith("device_idle"):
            assert reader(m["name"]).read({"trace": empty, "work": {}, "model": QWEN}) is None


def test_readers_declare_what_benchmark_says():
    """A reader names the cells it was written for; BENCHMARK.json may list
    more, as later cells add themselves."""
    for m in SPEC["per_layer"]:
        r = reader(m["name"])
        assert (r.LAYER, r.UNIT, r.BETTER, r.SOURCE, r.MOVES) == (
            m["layer"], m["unit"], m["better"], m["source"], m["moves"]), m["name"]
        assert set(r.WORKLOADS) <= set(m["workloads"]), m["name"]


def test_from_profiler_drops_annotations():
    """A record_function range shows on the device's timeline too: it is no
    device operation, and the stretch is its host span."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    def ev(name, s, e, dev, ann=False):
        return NS(name=name, time_range=NS(start=s, end=e), is_user_annotation=ann,
                  device_type=DeviceType.CUDA if dev else DeviceType.CPU)
    events = [ev(T.STRETCH, 0, 100, False), ev("bench.decode_step", 0, 90, False),
              ev(T.STRETCH, 1, 99, True, ann=True), ev("bench.decode_step", 1, 95, True),
              ev("bench.token_copy", 2, 50, True, ann=True),
              ev("void k<1>(int)", 10, 30, True), ev("aten::mm", 5, 9, False)]
    tr = T.from_profiler(NS(events=lambda: events), 1, {})
    assert tr.device == [("void k<1>(int)", 10, 30)]
    assert (tr.start_us, tr.end_us) == (0, 100)
    assert T.busy_s(tr) == pytest.approx(20e-6)
