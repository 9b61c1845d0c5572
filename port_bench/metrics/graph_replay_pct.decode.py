"""Share of a traced stretch's decode steps that replayed the step's CUDA
graph: 100 x the program's ``qt.graph_replay`` spans over its
``qt.decode_step`` spans.  The cache's first step captures the graph
(``qt.graph_capture``), so 16 steps of a fresh batch read 93.75.  A
program without the graph spans reads nothing."""
from port_bench.lib import spans as S

LAYER = "model step"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_span"
MOVES = "itl_ms_p95"
WORKLOADS = ["qwen3-8b-mxfp4.chat-b4"]


def read(ctx):
    spans = S.from_trace(ctx["trace"]) or {}
    steps = spans.get("qt.decode_step")
    if not steps or not ({"qt.graph_replay", "qt.graph_capture"} & spans.keys()):
        return None
    return 100.0 * spans.get("qt.graph_replay", {"count": 0})["count"] / steps["count"]
