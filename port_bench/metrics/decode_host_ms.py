"""Mean host milliseconds of a decode step in the window: from the step's
start to the return of ``models.decode_step``, before the token copy
(the benchmark's span around the program's call)."""
from port_bench.lib import readers as R

LAYER = "model step"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "itl_ms_p95"
WORKLOADS = ["qwen3-8b-mxfp4.chat-b4"]


def read(ctx):
    spans = (ctx["work"] or {}).get("decode_host_s")
    return 1e3 * sum(spans) / len(spans) if spans else None
