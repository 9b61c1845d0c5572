"""Host milliseconds a traced decode step spends inside the program's
``qt.decode_step`` span but in no ``qt.linear`` or ``qt.attend`` span: the
block's glue (norms, RoPE, cache writes, the MLP's gate product, residual
adds) and the head, on the traced stretch's profiler clock."""
from port_bench.lib import spans as S

LAYER = "model step"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "itl_ms_p95"
WORKLOADS = ["qwen3-8b-mxfp4.chat-b4"]


def read(ctx):
    trace = ctx["trace"]
    step = S.host_ms(trace, "qt.decode_step")
    if step is None:
        return None
    return step - sum(S.host_ms(trace, n) or 0.0 for n in ("qt.linear", "qt.attend"))
