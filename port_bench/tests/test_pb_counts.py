"""The yardstick's counts against values worked out by hand at Qwen3-8B's
shapes."""
import pytest

from port_bench import counts as C
from port_bench.lib import harness as H

QWEN = H.load_json(H.ROOT / "port_bench/configs/qwen3-8b-mxfp4.json")["model"]


def test_linear_shapes():
    assert C.linear_shapes(QWEN) == [(4096, 4096), (1024, 4096), (1024, 4096), (4096, 4096),
                                     (12288, 4096), (12288, 4096), (4096, 12288)]
    # 16.8M + 2 x 4.2M + 16.8M + 3 x 50.3M parameters a layer
    assert sum(n * k for n, k in C.linear_shapes(QWEN)) == 192_937_984


def test_fp4_gemm_bytes_and_bound():
    # (4, 4096, 12288): codes 0.5 B and a scale byte per 32 of each operand, bf16 out
    m, n, k = 4, 12288, 4096
    assert C.fp4_gemm_bytes(m, n, k) == (4 * 4096 + 12288 * 4096) // 2 \
        + (4 * 4096 + 12288 * 4096) // 32 + 2 * 4 * 12288
    # 25,174,016 code bytes + 1,573,376 scale bytes + 98,304 output bytes
    assert C.fp4_gemm_bytes(m, n, k) == 26_845_696
    assert C.fp4_gemm_bound_s(m, n, k) == pytest.approx(26_845_696 / 3.35e12)      # bytes bound
    # (512, 4096, 12288): 2 M N K = 51.5 GOP at 1979 TOP/s = 26.0 us, above 9.6 us of bytes
    assert C.fp4_gemm_bound_s(512, 12288, 4096) == pytest.approx(2 * 512 * 12288 * 4096 / 1979e12)


def test_model_flops():
    lin = 2 * 192_937_984 * 36
    assert C.linear_flops_per_token(QWEN) == lin
    assert C.attention_flops(QWEN, 100) == 36 * 4 * 32 * 128 * 100
    assert C.head_flops(QWEN) == 2 * 151936 * 4096
    # a 3-token prompt: three tokens' linears, contexts 1 + 2 + 3, one logits row
    assert C.prefill_flops(QWEN, 3) == 3 * lin + 36 * 4 * 32 * 128 * 6 + 2 * 151936 * 4096
    assert C.decode_flops(QWEN, 9) == lin + 36 * 4 * 32 * 128 * 10 + 2 * 151936 * 4096


def test_gemms_of_rows():
    g = C.gemms_of_rows(QWEN, 4)
    assert len(g) == 7 * 36 and g[0] == (4, 4096, 4096) and g[-1] == (4, 4096, 12288)
    # a decode step's GEMMs at M = 4 are bound by their bytes: ~0.54 B a parameter
    assert C.fp4_gemms_bound_s(g) == pytest.approx(
        sum(C.fp4_gemm_bytes(4, n, k) for _, n, k in g) / 3.35e12)
