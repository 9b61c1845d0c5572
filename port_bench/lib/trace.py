"""The reduction from a profiler trace to the numbers the per-layer
readers take.

A traced stretch is held as a ``Trace``: the device operations (kernels,
copies, sets) and the host operations, each a (name, start_us, end_us),
on the profiler's one clock, plus the stretch itself, a host span opened
before the stretch's first call and closed after its last synchronize.  Nothing is written to disk.
"""
from __future__ import annotations

from dataclasses import dataclass, field

STRETCH = "bench.stretch"
COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")


@dataclass
class Trace:
    device: list            # [(name, start_us, end_us)], sorted by start
    host: list              # [(name, start_us, end_us)]
    start_us: float
    end_us: float
    units: int = 1          # the decode steps, requests or training steps in the stretch
    work: dict = field(default_factory=dict)   # what the stretch did, for the readers

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) * 1e-6

    def in_stretch(self) -> list:
        """Device operations clipped to the stretch."""
        out = []
        for name, s, e in self.device:
            s, e = max(s, self.start_us), min(e, self.end_us)
            if e > s:
                out.append((name, s, e))
        return out

    def kernels(self) -> list:
        return [op for op in self.in_stretch() if not op[0].startswith(COPY_PREFIXES)]


def merged(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def busy_s(trace: Trace) -> float:
    """Seconds of the stretch in which any device operation ran."""
    return sum(e - s for s, e in merged((s, e) for _, s, e in trace.in_stretch())) * 1e-6


def idle_gaps(trace: Trace) -> list:
    """The stretch's idle intervals (start_us, end_us) between device
    operations, the ends of the stretch included."""
    busy = merged((s, e) for _, s, e in trace.in_stretch())
    gaps, at = [], trace.start_us
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if trace.end_us > at:
        gaps.append((at, trace.end_us))
    return gaps


def host_ops_at(trace: Trace, times) -> list:
    """For each of ``times`` (ascending), the innermost (shortest) host
    operation running then: one sweep with a heap of the open ones."""
    import heapq

    host = sorted((s, e, name) for name, s, e in trace.host if name != STRETCH)
    heap, out, i = [], [], 0
    for t in times:
        while i < len(host) and host[i][0] <= t:
            s, e, name = host[i]
            heapq.heappush(heap, (e - s, e, name))
            i += 1
        while heap and heap[0][1] < t:      # ended before t: closed for every later t
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else "(no host op)")
    return out


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps
    summed by what the host was doing at each gap's middle."""
    ops: dict = {}
    for name, s, e in trace.in_stretch():
        key = short_name(name)
        ops[key] = ops.get(key, 0.0) + (e - s) * 1e-6
    gaps: dict = {}
    spans = idle_gaps(trace)
    for (s, e), key in zip(spans, host_ops_at(trace, [(s + e) / 2 for s, e in spans])):
        gaps[key] = gaps.get(key, 0.0) + (e - s) * 1e-6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its trailing argument list, cut to ``width``."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i else name
                break
    return name[:width]


def from_profiler(prof, units: int, work: dict) -> Trace:
    """A ``Trace`` from a finished ``torch.profiler.profile`` whose
    stretch is marked with ``record_function(STRETCH)``."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    host = [(ev.name, ev.time_range.start, ev.time_range.end) for ev in events
            if ev.device_type != DeviceType.CUDA]
    host_names = {name for name, _, _ in host}
    # a host range (record_function) is mirrored on the device's timeline
    # as an annotation: it is no device operation
    device = [(ev.name, ev.time_range.start, ev.time_range.end) for ev in events
              if ev.device_type == DeviceType.CUDA
              and not getattr(ev, "is_user_annotation", False) and ev.name not in host_names]
    stretch = next(((s, e) for name, s, e in host if name == STRETCH), None)
    if stretch is None:
        raise RuntimeError("the traced stretch has no bench.stretch span")
    device.sort(key=lambda op: op[1])
    return Trace(device=device, host=host, start_us=stretch[0], end_us=stretch[1],
                 units=units, work=work)


def matching(trace: Trace, patterns) -> list:
    """Kernels of the stretch whose name holds any of ``patterns``."""
    return [op for op in trace.kernels() if any(p in op[0] for p in patterns)]


def total_s(ops) -> float:
    return sum(e - s for _, s, e in ops) * 1e-6
