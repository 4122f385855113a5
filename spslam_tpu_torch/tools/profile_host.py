"""Per-frame host-side cost breakdown of the live tracking loop (port of
tools/profile_host.py).

Each section of Tracker._dispatch / _resolve is timed through the tracker's
perf hooks (`Tracker.perf`, `Tracker._pt`) over the full System loop, async
mapper on as in the bench's point lane, and the table prints ms per
resolved frame for each section beside the median wall time per call.

Sections:
  upload      host->device copy of gray u8 + depth u16 (on the card: the
              enqueue of the copies)
  snapshot    local-map snapshot build / re-gather + upload
  dispatch    the fused step's launches (+ chain bookkeeping)
  wait_small  waiting for the frame's small output (the device's time)
  decode      small-buffer unpack + pose / velocity / jump-gate host math
  need_kf     keyframe decision
  kf_fetch    keyframe-bundle unpack (keyframe frames only)
  kf_insert   store insertion incl. new-point creation (keyframe frames only)
  stats_flush batched deferred visible/found statistic apply

A second table reads the span recorder (`spslam_tpu_torch/tracing.py`),
which the passes turn on: one row per span name and thread, with calls,
wall ms and the thread's CPU ms, per resolved frame for the tracker's
thread (its sections as `tracker.<section>`, the fused step's stages
`step.*`) and per keyframe for the mapping worker's (`worker.keyframe`,
`planes.*`, `mapper.*`, `loop.keyframe`, `tracker.refresh_snapshot`;
`pipeline.queue_wait` has no CPU time).  Wall less CPU is the time the
thread was ready but not running: the GIL, a lock, the scheduler.  This
table is where the stage and worker spans that no benchmark metric reads
are used.

    python -m spslam_tpu_torch.tools.profile_host [--device cpu] [n_frames] [n_passes]

With 40 frames it reads the bench's cached orbit render when present.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

SECTIONS = ("upload", "snapshot", "dispatch", "wait_small", "decode", "need_kf",
            "kf_fetch", "kf_insert", "stats_flush")


def load_sequence(n_frames: int):
    """The n_frames orbit with float frames; the bench's cached 40-frame
    render when n_frames is 40 and the cache exists."""
    from ..bench import load_cached
    from ..io.synthetic import make_sequence

    seq = load_cached("torch_orbit40", n_frames=40) if n_frames == 40 else None
    return seq if seq is not None else make_sequence(n_frames=n_frames)


def profile(seq, n_passes: int = 2, device=None) -> list[dict]:
    """A 12-frame warm-up, then n_passes passes of every frame with the
    tracker's sections and the span recorder on.  Each pass: perf (section
    -> seconds), n (frames resolved from the fused step), times (seconds
    per call), wall (s), spans (the recorder's spans of the pass)."""
    from .. import resolve_device, tracing
    from ..system import System, SystemConfig
    from ..tracking.tracker import TrackerConfig

    dev = resolve_device(device)

    def make_system():
        return System(SystemConfig(
            intr=seq.intr, local_ba=True, async_mapping=True,
            tracker=TrackerConfig(th_depth=3.2, pipeline_depth=3),
        ), device=dev)

    warm = make_system()
    for (g, d), ts in zip(seq.frames[:12], seq.timestamps[:12]):
        warm.track_rgbd(g, d, ts)
    warm.shutdown()
    print("warmup done", file=sys.stderr)

    passes = []
    tracing.enable()
    try:
        for _ in range(n_passes):
            tracing.reset()
            sys_ = make_system()
            sys_.tracker.perf = {}
            times = []
            t_pass0 = time.perf_counter()
            for (g, d), ts in zip(seq.frames, seq.timestamps):
                t0 = time.perf_counter()
                sys_.track_rgbd(g, d, ts)
                times.append(time.perf_counter() - t0)
            sys_.shutdown()
            wall = time.perf_counter() - t_pass0
            perf = dict(sys_.tracker.perf)
            n = perf.pop("n_frames", len(times))
            passes.append(dict(perf=perf, n=n, times=times, wall=wall, spans=tracing.records()))
    finally:
        tracing.disable()
        tracing.reset()
    return passes


def span_table(spans, n_frames: int) -> list[tuple]:
    """(name, thread, calls, wall ms, CPU ms or None, per) for each span name
    and thread, wall and CPU per resolved frame on the tracker's thread (the
    one that records `tracker.dispatch_frame`) and per keyframe elsewhere
    (the count of `worker.keyframe` spans), largest wall first."""
    tracker = next((s.thread for s in spans if s.name == "tracker.dispatch_frame"), None)
    n_kf = sum(1 for s in spans if s.name == "worker.keyframe")
    acc: dict = {}
    for s in spans:
        a = acc.setdefault((s.name, s.thread), [0, 0, 0, s.cpu_ns is not None])
        a[0] += 1
        a[1] += s.end_ns - s.start_ns
        a[2] += s.cpu_ns or 0
    rows = []
    for (name, thread), (calls, wall, cpu, has_cpu) in acc.items():
        per, n = ("frame", n_frames) if thread == tracker else ("keyframe", n_kf)
        n = max(n, 1)
        rows.append((name, thread, calls, wall / n * 1e-6, cpu / n * 1e-6 if has_cpu else None,
                     per))
    return sorted(rows, key=lambda r: (r[5], -r[3]))


def report(p: int, res: dict) -> float:
    """Print one pass's table; returns the accounted ms per resolved frame."""
    perf, times = res["perf"], res["times"]
    n = max(res["n"], 1)
    steady = np.array(times[5:])
    med = float(np.median(steady)) * 1000
    total_acct = sum(perf.values()) / n * 1000
    print(f"\npass {p}: median {med:.1f} ms/frame  "
          f"(mean {np.mean(steady) * 1000:.1f}, wall {res['wall']:.1f}s, "
          f"{len(times)} frames, {res['n']} resolved)")
    for k in sorted(SECTIONS, key=lambda k: -perf.get(k, 0.0)):
        v = perf.get(k, 0.0)
        print(f"  {k:12s} {v / n * 1000:7.2f} ms/frame ({v * 1000:7.1f} ms total)")
    print(f"  {'[accounted]':12s} {total_acct:7.2f} ms/frame; "
          f"median-minus-accounted = {med - total_acct:.2f} ms "
          f"(mapper contention, System bookkeeping and python glue)")
    print(f"  {'span':26s} {'thread':10s} {'calls':>5s} {'wall ms':>9s} {'cpu ms':>9s}")
    for name, thread, calls, wall, cpu, per in span_table(res["spans"], n):
        cpu_s = "-" if cpu is None else f"{cpu:9.2f}"
        print(f"  {name:26s} {thread:10s} {calls:5d} {wall:9.2f} {cpu_s:>9s} per {per}")
    return total_acct


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="host-side sections of the tracking loop")
    ap.add_argument("n_frames", type=int, nargs="?", default=40)
    ap.add_argument("n_passes", type=int, nargs="?", default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    from .. import resolve_device

    dev = resolve_device(args.device)
    print(f"device={dev}", file=sys.stderr)
    seq = load_sequence(args.n_frames)
    for p, res in enumerate(profile(seq, args.n_passes, dev)):
        report(p, res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
