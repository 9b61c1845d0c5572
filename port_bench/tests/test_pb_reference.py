"""The reference against the port's CPU path at a tiny size, the control
and the planted faults: a run whose timed path is broken comes out not
correct."""
import pytest
import torch

import tiny
from port_bench.reference import mxfp4
from port_bench.reference import qwen3_w4a4 as QREF


@pytest.mark.parametrize("steps,batch,model", [
    (6, 4, None), (0, 1, None),
    (4, 2, {"qk_norm": False, "tie_word_embeddings": True})])
def test_serving_reference_agrees_with_the_port(steps, batch, model):
    """The reference follows the configuration's knobs as the program does."""
    res = tiny.run(tiny.serving_cell(decode_steps=steps, batch=batch, model=model))
    assert res["correct"], res["checks"]
    assert res["checks"]["widest_logit_gap"]["value"] <= 1e-3
    assert res["checks"]["logit_max_abs_diff"]["value"] <= 1e-3


def test_a_method_the_reference_does_not_know_is_refused():
    x = torch.zeros((2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="quest"):
        mxfp4.weight_f64(x, mxfp4.hadamard(32, "cpu"), "abs_max")


def test_quantizer_matches_the_port_kernel_spec():
    """The reference's quantizer against the port's ordered plain version
    (the spec its kernel K1 is held to bit for bit)."""
    from qutlass_tpu_torch.ops import emulation as E
    g = torch.Generator().manual_seed(3)
    x = (torch.randn((64, 256), generator=g) * 3).to(torch.bfloat16)
    h = mxfp4.hadamard(32, "cpu")
    codes, byte, mask = mxfp4.quantize_quest(x, h)
    q, s, m = E.fused_quantize_mx_ordered_plain(x, h, rot_size=32, return_mask=True)
    assert torch.equal(E.pack_codes(codes), q)
    assert torch.equal(byte.to(torch.uint8), s[:64, :8])
    assert torch.equal(E.pack_mask(mask), m)


# -- planted faults: the timed path broken underneath, the run not correct ----

def _serving_fault(monkeypatch, wrap):
    from qutlass_tpu_torch import models as M
    real = M.decode_step
    monkeypatch.setattr(M, "decode_step", lambda *a, **k: wrap(real, *a, **k))
    return tiny.run(tiny.serving_cell())


def test_fault_token_altered(monkeypatch):
    def wrap(real, *a, **k):
        logits, cache = real(*a, **k)
        logits = logits.clone()
        logits[0, 7] = logits[0].max() + 1.0        # row 0 now serves token 7
        return logits, cache
    res = _serving_fault(monkeypatch, wrap)
    assert not res["correct"], res["checks"]


def test_fault_logits_altered_token_kept(monkeypatch):
    """Every logit 2% larger: the same tokens are served, the logits differ."""
    def wrap(real, *a, **k):
        logits, cache = real(*a, **k)
        return logits * 1.02, cache
    res = _serving_fault(monkeypatch, wrap)
    assert res["checks"]["widest_logit_gap"]["value"] <= 1e-3
    assert not res["correct"], res["checks"]


def test_fault_cache_left_unchanged(monkeypatch):
    def wrap(real, cfg, params, cache, *a, **k):
        logits, _ = real(cfg, params, [dict(c, k=c["k"].clone(), v=c["v"].clone())
                                       for c in cache], *a, **k)
        return logits, cache                       # the step's cache writes are lost
    res = _serving_fault(monkeypatch, wrap)
    assert not res["correct"], res["checks"]


# -- the controls: the reference one precision lower, in the program's place --

@pytest.mark.gpu
def test_serving_control_fails(cuda):
    """TF32 in the fp32 attention and head fails the serving limit: the
    chat cell at its own size, one batch."""
    from port_bench.lib import harness as H
    cell = H.Cell(H.load_json(H.ROOT / "BENCHMARK.json"), "qwen3-8b-mxfp4.chat-b4")
    driver = cell.driver()
    run = driver.Run(cell, 5, "cuda")
    run.setup()
    run.window(1.0)
    run.release()
    sample = run._sample()
    batches = run.reference_batches(sample)
    logits = run.reference_logits(batches, (False, True))
    ref, low = logits[False][0], logits[True][0]
    limits = cell.checks["limits"]
    assert QREF.widest_gap(ref, batches[0][2]) <= limits["widest_logit_gap"]
    assert driver.largest_diff(logits[False], run.program_logits(sample)) \
        <= limits["logit_max_abs_diff"]
    assert QREF.widest_gap(ref, batches[0][2], [lg.argmax(-1) for lg in low]) \
        > limits["widest_logit_gap"]
    assert driver.largest_diff(logits[False], logits[True]) > limits["logit_max_abs_diff"]
