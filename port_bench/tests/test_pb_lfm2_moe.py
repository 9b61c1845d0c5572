"""The LFM2-MoE cell's yardstick: the expert GEMMs' counts at the
configuration's shapes, the K18 roofline reader on a hand-made trace, and
a tiny cell through ``harness.run_cell`` on the CPU against the reference,
with its planted faults."""
import pytest

from port_bench import expert_counts as EC
from port_bench.lib import harness as H
from port_bench.lib import trace as T

CELL = "lfm2-24b-a2b-mxfp4.chat-b8"
SPEC = H.load_json(H.ROOT / "BENCHMARK.json")
LFM2 = H.load_json(H.ROOT / "port_bench/configs/lfm2-24b-a2b-mxfp4.json")
TYPES = ["conv", "conv", "full_attention", "conv"]
TINY = dict(LFM2, hidden_size=256, intermediate_size=512, layer_types=TYPES,
            moe_intermediate_size=128, num_attention_heads=4, num_dense_layers=1,
            num_experts=8, num_experts_per_tok=2, num_hidden_layers=4, num_key_value_heads=2,
            vocab_size=512, assumed=dict(LFM2["assumed"], head_dim=64))
LIMITS = {"widest_logit_gap": 0.05, "logit_max_abs_diff": 0.05}


def test_the_configuration_is_the_published_model():
    assert LFM2["reduced"] == [] and LFM2["layer_types"].count("full_attention") == 10
    assert [i for i, t in enumerate(LFM2["layer_types"]) if t != "conv"] == list(range(2, 40, 4))
    assert EC.expert_shapes(LFM2) == [(1536, 2048), (1536, 2048), (2048, 1536)]
    # 2.33 B parameters a token: 30 conv mixers of 4 D^2, 10 attention
    # mixers, 2 dense MLPs, 38 x (4 experts + router), the tied embedding
    active = EC.linear_flops_per_token(LFM2) // 2 + 65536 * 2048
    assert active == 30 * 4 * 2048 ** 2 + 10 * (2 * 2048 ** 2 + 2 * 512 * 2048) \
        + 2 * 3 * 11776 * 2048 + 38 * (4 * 3 * 1536 * 2048 + 64 * 2048) + 65536 * 2048
    assert active == 2_326_528_000


def test_expert_gemm_bytes_and_bound():
    # 25 active experts' gate weights (1536 x 2048: 1.5 M code bytes and
    # 98 K scale bytes each), 32 routed rows of 1024 + 64 bytes, bf16 out
    b = EC.expert_gemm_bytes(25, 32, 1536, 2048)
    assert b == 25 * (1536 * 1024 + 1536 * 64) + 32 * (1024 + 64) + 2 * 32 * 1536
    assert b == 41_912_320
    assert EC.expert_gemm_bound_s(25, 32, 1536, 2048) == pytest.approx(b / 3.35e12)
    # a prefill-sized launch is bound by its operations
    assert EC.expert_gemm_bound_s(1, 4096, 1536, 2048) == pytest.approx(
        2 * 4096 * 1536 * 2048 / 1979e12)


def test_expert_gemms_from_the_routing_counter():
    routed = [[[2, 0, 1], [1, 0, 1]], [[1, 1, 1], [1, 1, 1]]]     # two layers, three experts
    gemms = EC.expert_gemms(LFM2, routed)
    assert gemms == [(2, 3, 1536, 2048), (2, 3, 1536, 2048), (2, 3, 2048, 1536),
                     (3, 3, 1536, 2048), (3, 3, 1536, 2048), (3, 3, 2048, 1536)]
    assert EC.experts_bound_s(gemms) == pytest.approx(sum(
        EC.expert_gemm_bytes(a, r, n, k) for a, r, n, k in gemms) / 3.35e12)


def _reader():
    return H.load_module(H.BENCH / "metrics" / "gemm_fp4_experts_roofline.decode.py", "rd_k18")


def test_roofline_reader_on_a_hand_made_trace():
    gemms = [(25, 32, 1536, 2048), (25, 32, 1536, 2048), (25, 32, 2048, 1536)]
    bound_us = EC.experts_bound_s(gemms) * 1e6
    ops = [("void (anonymous namespace)::xp::gemm_fp4_experts<8, true>(...)", 10.0,
            10.0 + bound_us), ("void at::native::elementwise_kernel<...>", 0.0, 500.0),
           ("void (anonymous namespace)::dec::gemm_fp4_decode<...>", 100.0, 700.0)]
    trace = T.Trace(device=ops, host=[], start_us=0.0, end_us=1000.0, units=1,
                    work={"expert_gemms": gemms})
    # two launches of the grouped kernel took twice the bound: 50%
    trace.device.append(("void (anonymous namespace)::xp::gemm_fp4_experts<8, true>(...)",
                         800.0, 800.0 + bound_us))
    assert _reader().read({"trace": trace, "work": {}}) == pytest.approx(50.0)


def test_roofline_reader_reads_nothing_without_the_kernel_or_the_counters():
    ops = [("void at::native::elementwise_kernel<...>", 0.0, 5.0)]
    no_kernel = T.Trace(device=ops, host=[], start_us=0.0, end_us=10.0,
                        work={"expert_gemms": [(1, 1, 8, 32)]})
    ops = [("xp::gemm_fp4_experts<4, true>", 0.0, 5.0)]
    no_counter = T.Trace(device=ops, host=[], start_us=0.0, end_us=10.0, work={})
    for trace in (None, no_kernel, no_counter):
        assert _reader().read({"trace": trace, "work": {}}) is None


def test_the_cell_is_declared_with_its_metrics():
    cell = H.Cell(SPEC, CELL)
    assert cell.traffic["driver"] == "serve_lfm2_moe" and cell.traffic["batch"] == 8
    assert {m["name"] for m in cell.end_to_end()} == {"itl_ms_p95", "setup_s"}
    assert {m["name"] for m in cell.per_layer()} == {
        "decode_busy_ms", "device_idle_pct.decode", "graph_replay_pct.decode",
        "gemm_fp4_experts_roofline.decode"}
    # the stratified lengths of the issue: 348-2985 in four batches of 8
    from port_bench.lib import traffic as TR
    lens = sorted(n for b in TR.request_cycle(cell.traffic, 2 ** 31 + 5) for n in b)
    assert (lens[0], lens[-1], len(lens)) == (348, 2985, 32)


def tiny_cell(limits=None):
    tr = {"driver": "serve_lfm2_moe", "loop": "closed", "batch": 4, "decode_steps": 4,
          "prompt": {"dist": "lognormal", "median": 10, "sigma": 0.8, "min": 1, "max": 30},
          "cycle": 4, "repeat": 2, "trace": {"decode_steps": 2}}
    return H.Cell.from_parts(SPEC, CELL, TINY, tr,
                             {"batches": 1, "limits": dict(LIMITS, **(limits or {}))})


@pytest.mark.parametrize("key,value", [("conv_L_cache", 4), ("use_expert_bias", False),
                                       ("norm_topk_prob", False), ("routed_scaling_factor", 2.5)])
def test_driver_refuses_a_routing_or_conv_the_port_does_not_run(key, value):
    """The port fixes LFM2-MoE's conv width and routing: a configuration
    that differs is refused at set-up, not run as something else."""
    cell = tiny_cell()
    cell = H.Cell.from_parts(SPEC, CELL, dict(TINY, **{key: value}), cell.traffic, cell.checks)
    with pytest.raises(ValueError, match="the port's LFM2"):
        cell.driver().Run(cell, 2 ** 31 + 3, "cpu")._program_config()


def _run(cell, trace=0):
    import types
    args = types.SimpleNamespace(seed=2 ** 31 + 17, seconds=0.5, trace=trace)
    return H.run_cell(cell, args, 0.0, "cpu", {"platform": "cpu"})


def test_tiny_cell_runs_and_matches_the_reference():
    res = _run(tiny_cell())
    assert res["correct"], res["checks"]
    assert res["checks"]["widest_logit_gap"]["value"] == 0.0
    assert res["checks"]["logit_max_abs_diff"]["value"] == 0.0
    assert set(res["metrics"]) == {"itl_ms_p95", "setup_s"}
    traced = _run(tiny_cell(), trace=1)
    assert traced["correct"] and set(traced["breakdown"]) == {"device_ops", "idle_gaps"}


def test_traced_stretch_hands_the_reader_its_routing(monkeypatch):
    """The traced stretch's work: three grouped GEMMs an expert layer, the
    rows of every step's k routed tokens, at most every expert active."""
    cell = tiny_cell()
    run = cell.driver().Run(cell, 2 ** 31 + 3, "cpu")
    run.setup()
    trace = run.traced()
    gemms = trace.work["expert_gemms"]
    assert len(gemms) == 3 * 3
    for active, rows, n, k in gemms:
        assert rows == 2 * 4 * 2 and 2 <= active <= 2 * 8 and (n, k) in ((128, 256), (256, 128))


def test_fault_routing_altered_is_not_correct(monkeypatch):
    """A program whose router ignores the selection bias serves other
    experts' outputs: the check refuses it."""
    from qutlass_tpu_torch.models import experts as X
    real = X.route

    def unbiased(cfg, layer, x2):
        return real(cfg, {k: v for k, v in layer.items() if k != "expert_bias"}, x2)
    monkeypatch.setattr(X, "route", unbiased)
    res = _run(tiny_cell())
    assert not res["correct"], res["checks"]


def test_fault_conv_state_lost_is_not_correct(monkeypatch):
    """Decode steps whose conv windows restart from zeros each step."""
    from qutlass_tpu_torch.models import serving as S
    real = S._decode

    def forgetful(cfg, params, cache, *a):
        for c in cache:
            if "conv" in c:
                c["conv"].zero_()
        return real(cfg, params, cache, *a)
    monkeypatch.setattr(S, "_decode", forgetful)
    res = _run(tiny_cell())
    assert not res["correct"], res["checks"]
