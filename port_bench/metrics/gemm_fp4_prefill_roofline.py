"""Share of its roofline that K4's prefill kernel (the MXFP4 GEMM above
16 rows) reaches in the traced prefills: the work bound of every
projection GEMM of those prefills over the device time of the kernels
named below."""
from port_bench.lib import readers as R

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "ttft_ms_p95"
WORKLOADS = ["qwen3-8b-mxfp4.long-prompt"]
PATTERNS = ("gemm_fp4_prefill",)


def read(ctx):
    return R.fp4_gemm_roofline_pct(ctx["trace"], PATTERNS, lambda m: m > 16)
