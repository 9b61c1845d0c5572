"""LFM2-MoE on the port (``models.LFM2_24B_A2B``'s architecture at a tiny
size): short-conv layers beside attention, a dropless sigmoid-routed expert
layer, and K18, the grouped expert GEMM.  On the CPU, against the plain
reference ``port_bench/reference/lfm2_moe_w4a4.py``: prefill logits, then
decode through the cache, bit for bit; ragged conv state; the routing;
the grouped GEMM's plain route against K4's per expert.  On the card
(marked ``gpu``, skipping without one): K18 bit for bit against K4 on each
expert's rows, and a replayed LFM2 decode step bit for bit against the
eager one.  This file imports no JAX."""
import pytest
import torch

import qutlass_tpu_torch as qt
from port_bench.reference import lfm2_moe_w4a4 as R
from qutlass_tpu_torch import models as M
from qutlass_tpu_torch.kernels.gemm import gemm_fp4_experts
from qutlass_tpu_torch.models import experts as X
from qutlass_tpu_torch.models import serving as S
from qutlass_tpu_torch.models.shortconv import short_conv
from qutlass_tpu_torch.nn import mx_linear
from qutlass_tpu_torch.ops import dispatch
from qutlass_tpu_torch.ops import emulation as E
import torch_helpers  # noqa: F401  (the worker's thread budget)

TYPES = ("conv", "conv", "attention", "conv")
CFG = M.tiny_config(num_layers=4, layer_types=TYPES, num_experts=8, experts_per_token=2,
                    expert_width=128, num_dense_layers=1, tie_embeddings=True, rms_eps=1e-5)
# the same model under the source's configuration keys, as the reference reads it
MODEL = {"vocab_size": 512, "hidden_size": 256, "intermediate_size": 512,
         "num_hidden_layers": 4, "num_attention_heads": 4, "num_key_value_heads": 2,
         "layer_types": ["full_attention" if t == "attention" else t for t in TYPES],
         "conv_L_cache": 3, "norm_eps": 1e-5, "rope_parameters": {"rope_theta": 1e6},
         "num_dense_layers": 1, "num_experts": 8, "num_experts_per_tok": 2,
         "moe_intermediate_size": 128, "use_expert_bias": True, "norm_topk_prob": True,
         "routed_scaling_factor": 1.0}
QUANT = {"format": "mxfp4", "method": "quest", "rotation_size": 32}
LENS = [20, 7, 1, 2]          # 1 and 2 are shorter than the conv's window of 3
STEPS = 5


def model(dev):
    params = M.init_params(CFG, torch.Generator(device=dev).manual_seed(0), device=dev)
    h = qt.hadamard_matrix(32, device=dev)
    return params, M.quantize_model_weights(CFG, params, h, weight_format="fp4"), h


def prompts(dev, lens=LENS):
    g = torch.Generator(device=dev).manual_seed(1)
    t = max(lens)
    toks = torch.randint(0, CFG.vocab_size, (len(lens), t), generator=g, device=dev)
    lengths = torch.tensor(lens, device=dev)
    return toks.masked_fill(torch.arange(t, device=dev)[None] >= lengths[:, None], 0), lengths


def serve(qp, h, toks, lens, steps, decode=M.decode_step):
    """Ragged prefill, then greedy decode steps: (logits per served position, served [B, S+1])."""
    max_len = toks.shape[1] + steps
    logits, cache = M.prefill(CFG, qp, toks, h, max_len=max_len, quantized=True, lengths=lens)
    out, tok, pos = [logits], logits.argmax(-1), lens.clone()
    served = [tok]
    for _ in range(steps):
        logits, cache = decode(CFG, qp, cache, tok, pos, h, quantized=True)
        out.append(logits)
        tok = logits.argmax(-1)
        served.append(tok)
        pos = pos + 1
    return out, torch.stack(served, 1), cache


def reference(params, toks, lens, served, max_len, variants=(False,)):
    return R.served_logits(MODEL, QUANT, lambda i: params["layers"][i], params["embed"], None,
                           params["final_norm"], [(toks, lens, served, max_len)], variants)


@pytest.fixture(scope="module")
def cpu_model():
    return model(torch.device("cpu"))


def test_lfm2_preset_is_the_published_shape():
    c = M.LFM2_24B_A2B
    assert [i for i in range(40) if c.mixer(i) == "attention"] == list(range(2, 40, 4))
    assert (c.hidden_size, c.num_heads, c.num_kv_heads, c.head_dim) == (2048, 32, 8, 64)
    assert (c.num_experts, c.experts_per_token, c.expert_width) == (64, 4, 1536)
    assert not c.has_experts(1) and c.has_experts(2) and c.intermediate_size == 11776
    assert M.QWEN3_8B.mixer(35) == "attention" and not M.QWEN3_8B.has_experts(35)


def test_cache_holds_each_layer_kind(cpu_model):
    cache = M.init_cache(CFG, 3, 10, device="cpu")
    assert [sorted(c) for c in cache] == [["conv"], ["conv"], ["k", "v"], ["conv"]]
    assert cache[0]["conv"].shape == (3, 2, 256) and cache[0]["conv"].dtype == torch.float32
    assert S._first_state(cache) is cache[0]["conv"]


def test_prefill_and_decode_match_the_reference(cpu_model):
    """Ragged prefill logits, then decode through the cache, against the
    reference's teacher-forced pass: every served position bit for bit."""
    params, qp, h = cpu_model
    toks, lens = prompts("cpu")
    logits, served, _ = serve(qp, h, toks, lens, STEPS)
    ref = reference(params, toks, lens, served, toks.shape[1] + STEPS)[False][0]
    assert len(ref) == STEPS + 1
    for got, want in zip(logits, ref):
        assert torch.equal(got, want)


def test_forward_matches_prefill(cpu_model):
    """``forward`` runs the layers as ``prefill`` does, over a fresh cache
    of T positions: its last position's logits are prefill's bit for bit."""
    _, qp, h = cpu_model
    toks, _ = prompts("cpu", [12])
    full = M.forward(CFG, qp, toks, h, quantized=True)
    last, _ = M.prefill(CFG, qp, toks, h, max_len=12, quantized=True)
    assert torch.equal(full[:, -1], last)


def test_ragged_conv_state_is_each_rows_own(cpu_model):
    """After a ragged prefill each row's conv state is what that row's
    prompt alone leaves, zeros where it is shorter than the window."""
    _, qp, h = cpu_model
    toks, lens = prompts("cpu")
    _, cache = M.prefill(CFG, qp, toks, h, max_len=24, quantized=True, lengths=lens)
    for r, n in enumerate(LENS):
        _, alone = M.prefill(CFG, qp, toks[r:r + 1, :n], h, max_len=24, quantized=True)
        for i in (0, 1, 3):
            assert torch.equal(cache[i]["conv"][r], alone[i]["conv"][0]), (r, i)
    assert torch.equal(cache[0]["conv"][2, 0], torch.zeros(256))       # a 1-token prompt
    assert cache[0]["conv"][2, 1].abs().sum() > 0


def test_short_conv_window_moves_by_one():
    """Decode's in-place update: the state drops its oldest input and
    takes the new one; the output is the taps over the window."""
    g = torch.Generator().manual_seed(4)
    d, h = 64, qt.hadamard_matrix(32, device="cpu")
    layer = {"in_proj": (torch.randn(3 * d, d, generator=g) * 0.1).to(torch.bfloat16),
             "out_proj": torch.eye(d).to(torch.bfloat16),
             "conv": torch.randn(d, 3, generator=g).to(torch.bfloat16)}
    x = torch.randn(2, 1, d, generator=g).to(torch.bfloat16)
    state = torch.randn(2, 2, d, generator=g)
    old = state.clone()
    y = short_conv(layer, x, state, h, "quest", False)
    bg, cg, xg = (x.float() @ layer["in_proj"].float().T).to(torch.bfloat16).chunk(3, -1)
    bx = (bg.float() * xg.float())[:, 0]
    assert torch.equal(state[:, 0], old[:, 1]) and torch.equal(state[:, 1], bx)
    taps = layer["conv"].float()
    conv = old[:, 0] * taps[:, 0] + old[:, 1] * taps[:, 1] + bx * taps[:, 2]
    want = (cg[:, 0].float() * conv).to(torch.bfloat16)
    assert torch.equal(y[:, 0], (want.float() @ torch.eye(d)).to(torch.bfloat16))


def _router_case(bias_scale, seed=5):
    g = torch.Generator().manual_seed(seed)
    layer = {"router": (torch.randn(8, 256, generator=g) / 16).to(torch.bfloat16),
             "expert_bias": torch.randn(8, generator=g) * bias_scale}
    x2 = torch.randn(64, 256, generator=g).to(torch.bfloat16)
    return layer, x2


def test_routing_matches_the_reference():
    layer, x2 = _router_case(0.05)
    idx, w = X.route(CFG, layer, x2)
    logits = x2.float() @ layer["router"].float().T
    ridx, rw = R.route(MODEL, logits, layer["expert_bias"])
    assert torch.equal(idx, ridx) and torch.equal(w, rw)
    assert torch.allclose(w.sum(-1), torch.ones(64), atol=1e-5)


def test_expert_bias_moves_the_selection_not_the_weights():
    layer, x2 = _router_case(0.0)
    idx0, w0 = X.route(CFG, layer, x2)
    layer["expert_bias"][3] = 10.0
    idx, w = X.route(CFG, layer, x2)
    assert not torch.equal(idx, idx0)
    assert (idx[:, 0] == 3).all()                  # chosen first by every token
    s = torch.sigmoid(x2.float() @ layer["router"].float().T)
    picked = s.gather(1, idx)
    assert torch.equal(w, picked / (picked[:, 0] + picked[:, 1] + 1e-6)[:, None])


def test_dispatch_is_a_stable_counting_sort():
    idx = torch.tensor([[2, 0], [2, 1], [0, 2], [3, 1]])
    pos, rows, offsets = X.dispatch(idx, 5)
    assert offsets.tolist() == [0, 2, 4, 7, 8, 8]
    assert rows.tolist() == [0, 2, 1, 3, 0, 1, 2, 3]
    assert torch.equal(idx.reshape(-1)[torch.argsort(pos)], torch.tensor([0, 0, 1, 1, 2, 2, 2, 3]))


def test_routing_counter_counts_rows_and_active_calls(cpu_model):
    """Opt-in, and counted by the grouped GEMM's calls (up to DECODE_M
    tokens); a prefill's per-expert K4 leaves it."""
    _, qp, h = cpu_model
    assert not any("route_counts" in layer for layer in qp["layers"])
    params = {"layers": [dict(layer) for layer in qp["layers"]]}
    X.count_routes(params)
    assert [("route_counts" in layer) for layer in params["layers"]] == [False, True, True, True]
    layer = params["layers"][1]
    g = torch.Generator().manual_seed(2)
    x = torch.randn(1, 5, 256, generator=g).to(torch.bfloat16)
    X.moe(CFG, layer, x, h, "quest", True)
    X.moe(CFG, layer, x, h, "quest", True)
    rows, active = layer["route_counts"].clone()
    assert int(rows.sum()) == 2 * 5 * 2 and torch.equal(active, 2 * (rows > 0).long())
    X.moe(CFG, layer, torch.randn(1, 17, 256, generator=g).to(torch.bfloat16), h, "quest", True)
    assert torch.equal(layer["route_counts"], torch.stack([rows, active]))


def test_experts_refuse_unquantized_weights(cpu_model):
    params, _, h = cpu_model
    with pytest.raises(ValueError, match="W4A4"):
        M.forward(CFG, params, prompts("cpu", [4])[0], h)


@pytest.mark.parametrize("weight_method", ["quest", "abs_max"])
@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_mx_alpha_reaches_k4_and_k18(cpu_model, method, weight_method, monkeypatch):
    """A dense MX linear (K4) and the expert layer (K4 a prefill's expert,
    K18 a decode step's) pass the GEMM 1/3 for an abs-max activation times
    1/3 for an abs-max weight (``am``), each method and marker alike."""
    params, _, h = cpu_model
    want = {("quest", "quest"): 1.0, ("quest", "abs_max"): 1 / 3,
            ("abs_max", "quest"): 1 / 3, ("abs_max", "abs_max"): (1 / 3) * (1 / 3)}
    seen = []
    k4, k18 = qt.matmul_mxf4_bf16_kmajor, X.gemm_fp4_experts
    monkeypatch.setattr(qt, "matmul_mxf4_bf16_kmajor",
                        lambda *a: seen.append(("K4", a[4])) or k4(*a))
    monkeypatch.setattr(X, "gemm_fp4_experts",
                        lambda *a, **k: seen.append(("K18", a[5])) or k18(*a, **k))
    layer = dict(params["layers"][1])
    layer["experts"] = {n: X.quantize_stacked(w, h, weight_method)
                        for n, w in layer["experts"].items()}
    dense = M.quantize_weight(layer["router"], h=h, method=weight_method, weight_format="fp4")
    g = torch.Generator().manual_seed(3)
    mx_linear(torch.randn(3, 256, generator=g).to(torch.bfloat16), dense, h, method)
    for t in (5, 17):                        # K18 up to DECODE_M tokens, K4 above
        X.moe(CFG, layer, torch.randn(1, t, 256, generator=g).to(torch.bfloat16), h,
              method, True)
    assert {k for k, _ in seen} == {"K4", "K18"}
    assert all(a == want[method, weight_method] for _, a in seen), seen


def _grouped_case(dev, e=6, n=96, k=256, tokens=5, top=2, seed=7):
    g = torch.Generator(device=dev).manual_seed(seed)
    h = qt.hadamard_matrix(32, device=dev)
    w = (torch.randn(e, n, k, generator=g, device=dev) * k ** -0.5).to(torch.bfloat16)
    x = torch.randn(tokens, k, generator=g, device=dev).to(torch.bfloat16)
    idx = torch.stack([torch.randperm(e, generator=g, device=dev)[:top] for _ in range(tokens)])
    stored = X.quantize_stacked(w, h)
    xqt, xst = qt.fusedQuantizeMx(x, h, method="quest", layout="kmajor")
    _, rows, offsets = X.dispatch(idx, e)
    return stored, xqt, xst, rows, offsets


def _per_expert_k4(stored, xqt, xst, rows, offsets):
    off = offsets.tolist()
    out = []
    for e in range(len(off) - 1):
        cols = torch.arange(xqt.shape[1], device=xqt.device)[off[e]:off[e + 1]] if rows is None \
            else rows[off[e]:off[e + 1]].long()
        if cols.numel():
            out.append(qt.matmul_mxf4_bf16_kmajor(xqt[:, cols], stored["wqt"][e], xst[:, cols],
                                                  stored["wst"][e], 1.0))
    return torch.cat(out)


@pytest.mark.parametrize("gathered", [True, False])
def test_grouped_gemm_plain_route_is_k4_per_expert(gathered):
    stored, xqt, xst, rows, offsets = _grouped_case("cpu")
    if not gathered:               # the down projection's case: row r reads column r
        xqt, xst = xqt[:, rows.long()], xst[:, rows.long()]
        rows = None
    got = gemm_fp4_experts(xqt, xst, stored["wqt"], stored["wst"], offsets, 1.0, rows=rows,
                           max_rows=5)
    assert torch.equal(got, _per_expert_k4(stored, xqt, xst, rows, offsets))
    counts = torch.zeros((2, 6), dtype=torch.int64)
    assert torch.equal(got, E.gemm_fp4_experts_plain(xqt, xst, stored["wqt"], stored["wst"],
                                                     offsets, 1.0, rows=rows, counts=counts))
    n = offsets.diff().long()
    assert torch.equal(counts, torch.stack([n, (n > 0).long()]))


# -- on the card ------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("e,n,k,tokens,top,max_rows", [
    (64, 1536, 2048, 8, 4, 8),      # LFM2-24B-A2B's gate / up at decode batch 8
    (64, 2048, 1536, 8, 4, 8),      # its down projection
    (64, 1536, 2048, 4, 4, 4), (64, 1536, 2048, 16, 4, 16),
    (8, 96, 256, 40, 2, 4),         # more rows an expert than the row tile: tiles in turns
    (4, 200, 4096, 3, 2, 3)])       # K beyond one shared-memory slice; N not a tile multiple
def test_grouped_kernel_is_k4_per_expert_bitwise(dev, e, n, k, tokens, top, max_rows):
    stored, xqt, xst, rows, offsets = _grouped_case(dev, e, n, k, tokens, top)
    before = dispatch.launch_counts["gemm_fp4_experts"]
    counts = torch.full((2, e), 7, dtype=torch.int64, device=dev)
    got = gemm_fp4_experts(xqt, xst, stored["wqt"], stored["wst"], offsets, 1.0, rows=rows,
                           max_rows=max_rows, counts=counts)
    assert dispatch.launch_counts["gemm_fp4_experts"] == before + 1
    assert torch.equal(got, _per_expert_k4(stored, xqt, xst, rows, offsets))
    n = offsets.diff().long()
    assert torch.equal(counts, 7 + torch.stack([n, (n > 0).long()]))
    act = torch.randn(rows.numel(), k, device=dev).to(torch.bfloat16)     # row r reads column r
    aqt, ast = qt.fusedQuantizeMx(act, qt.hadamard_matrix(32, device=dev), layout="kmajor")
    got = gemm_fp4_experts(aqt, ast, stored["wqt"], stored["wst"], offsets,
                           torch.tensor([0.5], device=dev), max_rows=max_rows,
                           out_dtype=torch.float32)
    want = E.gemm_fp4_experts_plain(aqt.cpu(), ast.cpu(), stored["wqt"].cpu(),
                                    stored["wst"].cpu(), offsets.cpu(), 0.5,
                                    out_dtype=torch.float32)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_lfm2_replay_is_the_eager_step_bit_for_bit(dev):
    """Ragged LFM2 decode steps through ``decode_step``'s graph against the
    eager body on a second cache: the same logits and state bits, one
    capture, replays after, and the expert kernel in the graph, its
    routing counters counting in replays as in eager steps."""
    _, qp, h = model(dev)
    X.count_routes(qp)
    toks, lens = prompts(dev)

    def eager(cfg, params, cache, tok, pos, h, quantized):
        return S._decode(cfg, params, cache, tok, pos, h, quantized, "quest"), cache

    def counters():
        return torch.stack([layer["route_counts"] for layer in qp["layers"][1:]]).clone()

    before = dispatch.launch_counts["gemm_fp4_experts"]
    graphed, served, cache = serve(qp, h, toks, lens, STEPS)
    assert dispatch.launch_counts["gemm_fp4_experts"] - before == 3 * 3 * STEPS
    routed = counters()
    assert routed[:, 0].sum(-1).tolist() == [len(LENS) * 2 * STEPS] * 3
    plain, served_e, cache_e = serve(qp, h, toks, lens, STEPS, decode=eager)
    assert torch.equal(counters(), 2 * routed)
    assert torch.equal(served, served_e)
    for a, b in zip(graphed, plain):
        assert torch.equal(a, b)
    for c, ce in zip(cache, cache_e):
        for name in c:
            assert torch.equal(c[name], ce[name])
    assert S._GRAPHS.get(S._first_state(cache)) is not None
