"""The program's own spans (`spslam_tpu_torch/tracing.py`) for the per-layer
readers of traced runs.

Importing this module turns the program's span recorder on.  The harness
loads the readers, and so this module, only in `--trace 1` runs, in
`Bench.__init__`, before the warm-up: runs with `--trace 0` never record a
span.  A program without the recorder gives no spans, and the readers then
find nothing to read.

A span is (name, thread, start ns, end ns, CPU ns or None, id, parent id),
on the clock of the device trace (Unix nanoseconds).

Means per span take only the spans that lie wholly inside the window
(`whole`): stopping the profiler at the window's close takes 40-55 s on
the card, and a keyframe in flight across it reads that time as its own
(one such keyframe has lifted a traced run's mean of ~65 ms a keyframe
to seconds).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

try:
    from spslam_tpu_torch import tracing
except ImportError:      # a program without the recorder
    tracing = None
else:
    tracing.enable()

WORKER_THREAD = "mapping"


def spans(obs) -> list:
    """The recorder's spans that overlap the traced window, clipped to it
    (the CPU time is the whole span's)."""
    if tracing is None:
        return []
    lo, hi = obs.trace.t_open_ns, obs.trace.t_close_ns
    return [s._replace(start_ns=max(s.start_ns, lo), end_ns=min(s.end_ns, hi))
            for s in tracing.records() if s.end_ns > lo and s.start_ns < hi]


def whole(obs) -> list:
    """The recorder's spans that lie wholly inside the traced window."""
    if tracing is None:
        return []
    lo, hi = obs.trace.t_open_ns, obs.trace.t_close_ns
    return [s for s in tracing.records() if s.start_ns >= lo and s.end_ns <= hi]


def named(sp: Sequence, name: str) -> list:
    return [s for s in sp if s.name == name]


def mean_cpu_ms(sp: Sequence, name: str) -> Optional[float]:
    """Mean CPU ms of the spans called `name`, None without one."""
    cpu = [s.cpu_ns for s in named(sp, name)]
    return sum(cpu) / len(cpu) * 1e-6 if cpu else None


def overlap_ns(gaps: Sequence[Tuple[int, int]], intervals: Sequence[Tuple[int, int]]) -> int:
    """Total length of the intersection of two sets of intervals, each
    disjoint within itself."""
    a, b = sorted(gaps), sorted(intervals)
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def innermost(sp: Sequence, times: Sequence[int]) -> List[Optional[str]]:
    """For each of the sorted `times`, the name of the innermost span of
    `sp` open then (None where none is); the spans are one thread's, and
    nest."""
    order = sorted(sp, key=lambda s: (s.start_ns, -s.end_ns))
    out, stack, k = [], [], 0
    for t in times:
        while k < len(order) and order[k].start_ns <= t:
            s = order[k]
            k += 1
            while stack and stack[-1].end_ns < s.start_ns:
                stack.pop()
            stack.append(s)
        while stack and stack[-1].end_ns < t:
            stack.pop()
        out.append(stack[-1].name if stack else None)
    return out


def idle_by_span(gaps: Sequence[Tuple[int, int]], sp: Sequence) -> Dict[tuple, int]:
    """Idle ns of the device by the pair (the tracker thread's innermost
    span, the mapping worker's innermost span) open at each gap's middle.
    The tracker thread is the one that records `tracker.dispatch_frame`;
    spans without CPU time (`pipeline.queue_wait`, a wait and not work)
    are left out."""
    tracker = next((s.thread for s in sp if s.name == "tracker.dispatch_frame"), None)
    mids = [(a + b) // 2 for a, b in gaps]
    own = [s for s in sp if s.cpu_ns is not None]
    names_t = innermost([s for s in own if s.thread == tracker], mids)
    names_w = innermost([s for s in own if s.thread == WORKER_THREAD], mids)
    out: Dict[tuple, int] = {}
    for (a, b), nt, nw in zip(gaps, names_t, names_w):
        key = (nt or "-", nw or "-")
        out[key] = out.get(key, 0) + (b - a)
    return out


def attribution_line(gaps: Sequence[Tuple[int, int]], sp: Sequence, window_s: float,
                     top: int = 10) -> str:
    """One line: the `top` pairs of `idle_by_span` with their idle seconds
    and share of the window."""
    pairs = sorted(idle_by_span(gaps, sp).items(), key=lambda kv: -kv[1])[:top]
    parts = [f"{t} | {w}: {ns * 1e-9:.3f} s ({100.0 * ns * 1e-9 / window_s:.1f}%)"
             for (t, w), ns in pairs]
    return "device idle by (tracker span | worker span): " + "; ".join(parts)
