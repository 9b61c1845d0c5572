"""Which kernel K4 (MXFP4) and K7 (NVFP4) run for a call:
``kernels.gemm.fp4_kernel`` decides from the format, the layout and the
shape alone, and the wrappers run its choice.  CPU only: no kernel runs
here."""
import pytest
import torch

import torch_helpers  # noqa: F401  (the port tests' thread budget)
from qutlass_tpu_torch.kernels import gemm as G

QWEN3_KN = ((4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096))
LFM2_KN = ((2048, 2048), (2048, 512), (2048, 11776), (11776, 2048), (2048, 1536), (1536, 2048))


@pytest.mark.parametrize("fmt", ["mx", "nv"])
@pytest.mark.parametrize("m", [1, 4, 8, 13, 16])
def test_kmajor_up_to_decode_m_runs_the_decode_kernel(fmt, m):
    for k, n in QWEN3_KN + LFM2_KN:
        assert G.fp4_kernel(fmt, "kmajor", m, n, k) == "decode"


@pytest.mark.parametrize("fmt", ["mx", "nv"])
@pytest.mark.parametrize("m", [17, 63, 64, 345, 1596, 6523, 6524, 65536])
def test_kmajor_above_decode_m_runs_the_prefill_kernel(fmt, m):
    """Every K-major call above ``DECODE_M`` rows runs the prefill kernel
    (``gemm_fp4_prefill.cuh``): K4's warp-specialised kernel is not in the
    library, so no shape takes it."""
    for k, n in QWEN3_KN + LFM2_KN + ((4128, 33),):
        assert G.fp4_kernel(fmt, "kmajor", m, n, k) == "prefill"


@pytest.mark.parametrize("fmt,layout", [("mx", "tn"), ("mx", "kmajor_codes"), ("nv", "tn")])
@pytest.mark.parametrize("m", [1, 16, 17, 512, 6523])
def test_tn_and_codes_run_the_prefill_kernel_at_any_m(fmt, layout, m):
    """The row-major layout and unpacked codes have no decode kernel."""
    assert G.fp4_kernel(fmt, layout, m, 4096, 4096) == "prefill"


def test_an_unknown_format_raises():
    with pytest.raises(ValueError):
        G.fp4_kernel("fp8", "kmajor", 512, 4096, 4096)


@pytest.mark.parametrize("m,off,rows_extra,word", [
    (17, 0, 0, False), (6523, 0, 0, False), (6522, 0, 0, False), (6524, 0, 0, True),
    (512, 0, 0, True), (512, 1, 0, False), (512, 4, 0, True), (64, 0, 2, False),
    (64, 0, 4, True)])
def test_word_rows_is_the_prefill_kernels_vector_load_rule(m, off, rows_extra, word):
    """``word_rows`` states ``pre::vec_rows`` for a K-major packed activation
    [K/2, M] (its logical view [M, K/2] has unit stride along the rows):
    4-byte words of rows where M % 4 == 0 and base and k-row stride are
    multiples of 4 bytes; else K4's wrapper pads it (a column slice at
    ``off`` of a tensor ``rows_extra`` columns wider)."""
    big = torch.zeros((64, m + off + rows_extra), dtype=torch.uint8)
    a = big[:, off:off + m]
    assert a.data_ptr() % 4 == off % 4 and big.data_ptr() % 4 == 0
    assert G.word_rows(a.T, m) is word
    assert not G.word_rows(big.repeat(1, 2)[:, ::2][:, :m].T, m)   # stride 2 along the rows
