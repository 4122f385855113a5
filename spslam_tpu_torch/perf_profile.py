"""Where the time goes on the card: one run of the port's point-only path,
or with --planes of its point+plane path.

    python3 -m spslam_tpu_torch.perf_profile [--frames 20] [--planes] [--out FILE.json]

Renders the synthetic orbit sequence (with --planes: the low-texture,
noisy-depth orbit of the planes lane, seed 7, at pipeline depth 2 and
th_depth 3.2), then drives System(...).track_rgbd three ways on the CUDA
device:

1. plain run: host wall time per track_rgbd call (the user's per-frame
   cost; frames 5.. are the steady window);
2. sectioned run: the same with torch.cuda.synchronize() around each host
   section (tracker dispatch, tracker resolve, plane mapper, mapper fuse,
   mapper BA, rest of the mapper), which attributes device time to the section that
   queued it at the price of the pipeline's overlap;
3. torch.profiler over a steady window: device time per kernel name and
   the device's busy share of the window's wall time.

It also times one fused step (track_frame_step) alone: device time from
CUDA events, host enqueue time from the host clock, and its kernels and
host syncs counted by the profiler; with --planes, the same step without
its plane branch too.  Prints a JSON summary
and, with --out, writes it (with the per-call times) to that file.  Needs a CUDA device; it is a measurement tool and
has no CPU mode.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch


def _card() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60,
    )
    return res.stdout.strip()


def _frames(seq):
    return [(np.clip(g, 0, 255).astype(np.uint8),
             np.clip(d * 5000.0, 0, 65535).astype(np.uint16)) for g, d in seq.frames]


def _new_system(seq, planes):
    from .system import System, SystemConfig
    from .tracking.tracker import TrackerConfig

    tracker = TrackerConfig(th_depth=3.2, pipeline_depth=2) if planes else TrackerConfig()
    return System(SystemConfig(intr=seq.intr, local_ba=True, enable_reloc=False,
                               use_planes=planes, tracker=tracker), device="cuda")


def plain_run(seq, frames, planes):
    sys_ = _new_system(seq, planes)
    times = []
    for (g, d), ts in zip(frames, seq.timestamps):
        t0 = time.perf_counter()
        sys_.track_rgbd(g, d, ts)
        times.append(time.perf_counter() - t0)
    sys_.shutdown()
    torch.cuda.synchronize()
    return sys_, np.array(times)


def sectioned_run(seq, frames, planes):
    """Run with synchronising timers wrapped around the host sections."""
    from .mapping import fuse, local_mapper, plane_mapper
    from .tracking import tracker

    acc: dict[str, float] = {}
    patched = []

    def wrap(owner, name, key):
        fn = getattr(owner, name)

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0
            return out

        setattr(owner, name, timed)
        patched.append((owner, name, fn))

    wrap(tracker.Tracker, "_dispatch", "tracker_dispatch_and_step")
    wrap(tracker.Tracker, "_resolve", "tracker_resolve")
    wrap(tracker.Tracker, "process", "tracker_sync_path")
    wrap(local_mapper.LocalMapper, "process_keyframe", "mapper_total")
    wrap(fuse, "search_in_neighbors", "mapper_fuse")
    wrap(local_mapper.LocalMapper, "local_ba", "mapper_local_ba")
    wrap(plane_mapper.PlaneMapper, "process_keyframe", "plane_mapper")
    try:
        sys_, times = plain_run(seq, frames, planes)
    finally:
        for owner, name, fn in patched:
            setattr(owner, name, fn)
    n_kf_calls = sum(1 for m in sys_.tracker.metrics if m.get("kf"))
    return {k: v * 1e3 for k, v in acc.items()}, float(times.sum() * 1e3), n_kf_calls


# host-side events that wait for the device (their count per frame)
SYNC_EVENTS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
               "aten::item", "aten::_local_scalar_dense")


def profiled_window(seq, frames, planes, lo=8, hi=14):
    from torch.profiler import ProfilerActivity, profile

    sys_ = _new_system(seq, planes)
    for (g, d), ts in zip(frames[:lo], seq.timestamps[:lo]):
        sys_.track_rgbd(g, d, ts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for (g, d), ts in zip(frames[lo:hi], seq.timestamps[lo:hi]):
            sys_.track_rgbd(g, d, ts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    sys_.shutdown()
    rows = []
    busy_us = 0.0
    n_kernels = 0
    syncs = {}
    for ev in prof.key_averages():
        if ev.key in SYNC_EVENTS:
            syncs[ev.key] = ev.count
        dev_us = float(getattr(ev, "self_device_time_total", 0.0)
                       or getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us <= 0:
            continue
        if ev.device_type is not None and "CUDA" not in str(ev.device_type):
            continue
        rows.append((dev_us, ev.count, ev.key))
        busy_us += dev_us
        n_kernels += ev.count
    rows.sort(reverse=True)
    n = hi - lo
    return dict(
        frames=n, wall_ms_per_frame=wall * 1e3 / n,
        device_busy_ms_per_frame=busy_us / 1e3 / n,
        device_busy_share=busy_us / 1e6 / wall if wall > 0 else None,
        device_ops_per_frame=n_kernels / n,
        host_syncs_per_frame={k: c / n for k, c in syncs.items()},
        top=[dict(name=k[:90], device_ms_per_frame=us / 1e3 / n, calls_per_frame=c / n)
             for us, c, k in rows[:20]],
    )


def fused_step_alone(seq, frames, planes, reps=20):
    """Device and host-enqueue time of track_frame_step on a fixed map."""
    sys_ = _new_system(seq, planes)
    for (g, d), ts in zip(frames[:6], seq.timestamps[:6]):
        sys_.track_rgbd(g, d, ts)
    sys_.shutdown()
    tr = sys_.tracker
    from .tracking.tracker import track_frame_step

    ids, pack, desc, pl_pack = tr._local_snapshot()
    g_t, d_t = tr._upload_frame(*frames[6])
    T = torch.tensor(tr.T_cw, device="cuda")
    cfg = tr.cfg

    def timed(planes_pack):
        def step():
            return track_frame_step(
                g_t, d_t, T, T, tr._hv[1], pack, desc, cfg.motion_search_radius,
                cfg.local_search_radius, cfg.th_depth, tr.spec, tr.intr, cfg.n_features,
                cfg.th_fast_high, cfg.th_fast_low, depth_factor=tr.depth_factor,
                pl_pack=planes_pack)

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        dev, host = [], []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            t0 = time.perf_counter()
            step()
            host.append(time.perf_counter() - t0)
            b.record()
            b.synchronize()
            dev.append(a.elapsed_time(b))
        kernels, syncs = _count_one(step)
        return dict(event_ms=float(np.median(dev)),
                    host_enqueue_ms=float(np.median(host) * 1e3),
                    kernels=kernels, host_syncs=syncs)

    out = timed(pl_pack)
    if pl_pack is not None:
        # the same step on the same map and frame without the plane branch
        out["without_planes"] = timed(None)
    return out


def _count_one(fn):
    """(device kernels, host sync events by name) of one call of fn; the
    torch.cuda.synchronize() that closes the window counts among them."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = 0
    syncs = {}
    for ev in prof.key_averages():
        if ev.key in SYNC_EVENTS:
            syncs[ev.key] = ev.count
        dev_us = float(getattr(ev, "self_device_time_total", 0.0) or 0.0)
        if dev_us > 0 and "CUDA" in str(ev.device_type):
            kernels += ev.count
    return kernels, syncs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--planes", action="store_true",
                    help="the point+plane path on the low-texture sequence")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("perf_profile needs a CUDA device")
    from .eval.ate import ate_rmse
    from .io.synthetic import make_sequence

    if args.planes:
        seq = make_sequence(n_frames=args.frames, low_texture=True, depth_noise=0.008, seed=7)
    else:
        seq = make_sequence(n_frames=args.frames)
    frames = _frames(seq)
    out = dict(card=_card(), torch=torch.__version__, cuda=torch.version.cuda,
               planes=args.planes)
    sys_, times = plain_run(seq, frames, args.planes)   # warms every kernel and table
    sys_, times = plain_run(seq, frames, args.planes)
    out["plain"] = dict(
        steady_median_ms=float(np.median(times[5:]) * 1e3),
        steady_mean_ms=float(np.mean(times[5:]) * 1e3),
        first_frame_ms=float(times[0] * 1e3),
        ate_mm=float(ate_rmse(sys_.poses(), seq.poses_gt)[0] * 1e3),
        n_kf=int(sys_.store.n_kf), n_fused=int(sys_.tracker.n_fused),
        n_planes=int(sys_.store.pl_valid.sum()),
        per_call_ms=[round(float(x) * 1e3, 3) for x in times],
    )
    sections, total_ms, n_kf = sectioned_run(seq, frames, args.planes)
    out["sectioned"] = dict(total_ms=total_ms, keyframes=n_kf,
                            sections_ms=sections)
    out["fused_step_alone"] = fused_step_alone(seq, frames, args.planes)
    out["profile"] = profiled_window(seq, frames, args.planes)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "plain"} | {
        "plain": {k: v for k, v in out["plain"].items() if k != "per_call_ms"}}, indent=1))


if __name__ == "__main__":
    main()
