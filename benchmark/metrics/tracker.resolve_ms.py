"""Host ms per resolved frame spent resolving it: the wait for the
device's small output and keyframe insertion, the Tracker.perf sections
wait_small + decode + need_kf + kf_fetch + kf_insert + stats_flush over
n_frames."""

SECTIONS = ("wait_small", "decode", "need_kf", "kf_fetch", "kf_insert", "stats_flush")


def read(obs):
    n = obs.perf.get("n_frames", 0)
    return sum(obs.perf.get(k, 0.0) for k in SECTIONS) / n * 1e3 if n else None
