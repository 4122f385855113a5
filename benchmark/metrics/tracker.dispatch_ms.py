"""Host ms per resolved frame spent enqueueing the fused step: the
Tracker.perf sections upload + snapshot + dispatch over n_frames."""

SECTIONS = ("upload", "snapshot", "dispatch")


def read(obs):
    n = obs.perf.get("n_frames", 0)
    return sum(obs.perf.get(k, 0.0) for k in SECTIONS) / n * 1e3 if n else None
