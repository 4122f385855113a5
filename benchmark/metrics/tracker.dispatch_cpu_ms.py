"""The tracker thread's CPU ms per resolved frame in the intervals that
tracker.dispatch_ms times: the program's `tracker.upload`,
`tracker.snapshot` and `tracker.dispatch` spans of the window over the
Tracker.perf frame count.  tracker.dispatch_ms less this is the time the
thread was ready to launch but not running (the GIL, the store's lock,
the scheduler)."""

from benchmark import program_spans

NAMES = ("tracker.upload", "tracker.snapshot", "tracker.dispatch")


def read(obs):
    n = obs.perf.get("n_frames", 0)
    cpu = [s.cpu_ns for s in program_spans.spans(obs) if s.name in NAMES]
    return sum(cpu) / n * 1e-6 if cpu and n else None
