"""The reader of the decode step's CUDA graph spans, on a synthetic ``Trace``."""
import pytest

from port_bench.lib import harness as H
from port_bench.lib import trace as T


def read(ctx):
    return H.load_module(H.BENCH / "metrics" / "graph_replay_pct.decode.py",
                         "s_graph_replay_pct_decode").read(ctx)


def steps_trace(n=16, replayed=True):
    """``n`` decode steps of a fresh batch: the first captures, the others
    replay (or, with ``replayed=False``, carry no graph span after the capture)."""
    host = [(T.STRETCH, 0, 100 * n)]
    for i in range(n):
        host.append(("qt.decode_step", 100 * i, 100 * i + 90))
        if i == 0:
            host.append(("qt.graph_capture", 1, 80))
        elif replayed:
            host.append(("qt.graph_replay", 100 * i + 1, 100 * i + 80))
    return T.Trace(device=[("k", 0, 5)], host=host, start_us=0, end_us=100 * n, units=n)


def test_graph_replay_reader():
    """16 traced steps of a fresh batch: the first captures, 15 replay."""
    assert read({"trace": steps_trace(), "work": {}}) == pytest.approx(93.75)


def test_graph_replay_reader_without_replays():
    """Steps that stay eager after their capture read 0."""
    assert read({"trace": steps_trace(replayed=False), "work": {}}) == 0.0


def test_graph_replay_reader_without_graph_spans():
    """A program with no graph spans, or no trace, reads nothing."""
    host = [(T.STRETCH, 0, 100), ("qt.decode_step", 1, 90), ("qt.linear", 10, 60)]
    bare = T.Trace(device=[("k", 20, 30)], host=host, start_us=0, end_us=100, units=1)
    assert read({"trace": bare, "work": {}}) is None
    assert read({"trace": None, "work": {}}) is None
