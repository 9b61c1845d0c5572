"""Host milliseconds a traced decode step spends inside the program's
``qt.linear`` spans (``nn/linear.quantized_linear``: the activation
quantize, the GEMM's wrapper and the glue around them), inclusive, on the
traced stretch's profiler clock: it compares only with other traced runs."""
from port_bench.lib import spans as S

LAYER = "quantized linear"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "itl_ms_p95"
WORKLOADS = ["qwen3-8b-mxfp4.chat-b4"]


def read(ctx):
    return S.host_ms(ctx["trace"], "qt.linear")
