"""The device trace of a `--trace 1` run.

The profiler records CUDA activity only and keeps its raw events in
memory; nothing is exported (a window holds over a million kernels).
`device_events` reads them as `spslam_tpu_torch/tools/profile_frame.
trace_events` does (a frozen copy of its reading, device events only, with
their start times), in about a microsecond an event instead of the minutes
`key_averages()` takes.  Event times are Unix nanoseconds, the clock of
`time.time_ns()`, so the harness's host spans line up with them.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

COPY_PREFIXES = ("Memcpy", "Memset")


class DeviceTrace(NamedTuple):
    events: List[Tuple[str, int, int]]   # (name, start ns, end ns) inside the window
    busy_ns: int                          # union of the events' intervals
    gaps: List[Tuple[int, int]]           # idle intervals, in time order
    t_open_ns: int
    t_close_ns: int

    @property
    def window_s(self) -> float:
        return (self.t_close_ns - self.t_open_ns) * 1e-9

    @property
    def busy_s(self) -> float:
        return self.busy_ns * 1e-9

    def kernels(self) -> List[Tuple[str, int, int]]:
        return [e for e in self.events if not e[0].startswith(COPY_PREFIXES)]


def start(device):
    """A started profiler that records the card's activity only (the host's
    when `device` is the CPU, which has no device events)."""
    import torch

    act = torch.profiler.ProfilerActivity
    prof = torch.profiler.profile(activities=[act.CUDA if device.type == "cuda" else act.CPU])
    prof.start()
    return prof


def device_events(prof) -> List[Tuple[str, int, int]]:
    """(name, start ns, end ns) of every device event of a stopped profiler."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_hidden_event():
            s = e.start_ns()
            out.append((e.name(), s, s + e.duration_ns()))
    return out


def summarize(events: Sequence[Tuple[str, int, int]], t_open_ns: int,
              t_close_ns: int) -> DeviceTrace:
    """Clip the events to the window and take the union of their intervals."""
    inside = [(n, max(s, t_open_ns), min(e, t_close_ns)) for n, s, e in events
              if e > t_open_ns and s < t_close_ns]
    inside.sort(key=lambda x: x[1])
    busy, gaps, cur = 0, [], t_open_ns
    for _, s, e in inside:
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if cur < t_close_ns:
        gaps.append((cur, t_close_ns))
    return DeviceTrace(inside, busy, gaps, t_open_ns, t_close_ns)


def breakdown(tr: DeviceTrace, spans: Sequence[Tuple[str, int, int]], top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by the host spans open at its middle."""
    by_name: dict = {}
    for n, s, e in tr.events:
        by_name[n] = by_name.get(n, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(tr.gaps, key=lambda g: g[0] - g[1])[:top]
    named = []
    for s, e in gaps:
        mid = (s + e) // 2
        open_ = sorted({label for label, a, b in spans if a <= mid <= b})
        named.append(["+".join(open_) or "no span", (e - s) * 1e-9])
    return {"device_ops": [[n[:200], ns * 1e-9] for n, ns in ops], "idle_gaps": named}
