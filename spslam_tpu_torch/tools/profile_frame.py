"""Per-stage profile of the tracking path (port of tools/profile_frame.py).

Steady medians, one stage at a time, each call fenced by
torch.cuda.synchronize() on the card:

  * the frontend stages build_frame runs (ops/pyramid.build_pyramid_levels,
    ops/fast.detect_levels with its one FAST+NMS kernel launch,
    ops/brief.describe_levels) and build_frame itself;
  * the fused track_frame_step on a random 4,096-point snapshot;
  * host<->card copies: a tiny device->host round trip, the 300 KB u8
    gray upload and the 128 KB float32 snapshot upload.

    python -m spslam_tpu_torch.tools.profile_frame [--device cpu] [n_iters]

Also the fused-step inputs, the fenced timer and the profiler-trace reader
the other profile tools share (`fused_inputs`, `median_ms`, `trace_events`,
`device_work`).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def median_ms(fn, device: torch.device, n: int = 20, warmup: int = 3) -> float:
    """Median ms of single calls of fn, each fenced by a device sync."""
    for _ in range(warmup):
        fn()
    sync(device)
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        sync(device)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def trace_events(prof) -> list:
    """[(name, on the device, µs)] of every event of a finished
    torch.profiler trace, read from its raw events: `key_averages()` builds
    a Python object per event first, seconds for the ~30,000 launches of
    one fused step.  The device's events are its kernels, copies and sets;
    the host's carry the ops and the CUDA runtime calls (the syncs).  As in
    `key_averages()`, a host event inside one of the same name on its
    thread (one op through several dispatch layers) counts once."""
    from torch.autograd import DeviceType

    out, open_until = [], {}
    for e in sorted(prof.profiler.kineto_results.events(), key=lambda e: e.start_ns()):
        if e.is_hidden_event():
            continue
        on_device = e.device_type() == DeviceType.CUDA
        if not on_device:
            key = (e.name(), e.start_thread_id())
            if e.end_ns() <= open_until.get(key, -1):
                continue
            open_until[key] = e.end_ns()
        out.append((e.name(), on_device, e.duration_ns() / 1e3))
    return out


def device_work(events) -> tuple:
    """(events, µs) on the device in a trace_events list, counted as
    `key_averages()` counts them: every event of a name whose events took
    device time."""
    busy = {}
    for name, on_device, us in events:
        if on_device:
            n, t = busy.get(name, (0, 0.0))
            busy[name] = (n + 1, t + us)
    return (sum(n for n, t in busy.values() if t > 0),
            sum(t for _, t in busy.values()))


def fused_inputs(seq, cfg, device: torch.device, frame: int = 0) -> dict:
    """The fused step's inputs as the Tracker uploads them: frame `frame`'s
    gray as u8 and its depth as raw u16 units (int16 bits) at the upload
    stride, a random [PL, 9] snapshot (pos | normal | min_d | max_d, valid
    column 1) and random descriptors, the identity pose, the pyramid spec."""
    from ..ops.pyramid import PyramidSpec

    gray, depth = seq.frames[frame]
    g = gray if gray.dtype == np.uint8 else np.clip(gray, 0, 255).astype(np.uint8)
    d = depth if depth.dtype == np.uint16 else np.clip(depth * 5000.0, 0, 65535).astype(np.uint16)
    s = cfg.depth_upload_stride
    d = np.ascontiguousarray(d[::s, ::s])
    PL = cfg.local_points_cap
    pack = np.random.RandomState(0).randn(PL, 9).astype(np.float32)
    pack[:, 8] = 1.0
    desc = np.random.RandomState(1).randint(0, 2 ** 32, (PL, 8), np.uint64).astype(np.uint32)
    intr = seq.intr
    return dict(
        gray=torch.from_numpy(g).to(device), depth=torch.from_numpy(d.view(np.int16)).to(device),
        pack=torch.from_numpy(pack).to(device),
        desc=torch.from_numpy(desc.view(np.int32)).to(device),
        T0=torch.tensor([1, 0, 0, 0, 0, 0, 0], dtype=torch.float32, device=device),
        spec=PyramidSpec(n_levels=cfg.n_levels, scale_factor=cfg.scale_factor,
                         height=intr.height, width=intr.width),
        intr=intr, cfg=cfg, device=device)


def real_step(x: dict, T_prev, T_prev2, has_vel):
    """The real track_frame_step on fused_inputs x (point-only)."""
    from ..tracking.tracker import track_frame_step

    cfg = x["cfg"]
    return track_frame_step(
        x["gray"], x["depth"], T_prev, T_prev2, has_vel, x["pack"], x["desc"],
        cfg.motion_search_radius, cfg.local_search_radius, cfg.th_depth, x["spec"], x["intr"],
        cfg.n_features, cfg.th_fast_high, cfg.th_fast_low)


def profile(seq, cfg, device, n: int = 20, warmup: int = 3) -> dict:
    """Stage -> median ms; '_frames' counts the frames the stages built
    (each one FAST+NMS launch on the card)."""
    from ..frontend.frame import build_frame
    from ..ops.brief import describe_levels
    from ..ops.fast import detect_levels, level_feature_counts
    from ..ops.pyramid import build_pyramid_levels
    from ..tracking.tracker import decode_depth

    x = fused_inputs(seq, cfg, device)
    spec, intr = x["spec"], x["intr"]
    gray_f = x["gray"].to(torch.float32)
    depth_f = decode_depth(x["depth"], 5000.0)
    r = {}
    levels, levels_blur = build_pyramid_levels(gray_f, spec, blur=True)
    r["build_pyramid_levels"] = median_ms(
        lambda: build_pyramid_levels(gray_f, spec, blur=True), device, n, warmup)
    det = detect_levels(levels, spec, n_features=cfg.n_features)
    r["detect_levels"] = median_ms(
        lambda: detect_levels(levels, spec, n_features=cfg.n_features), device, n, warmup)
    counts = level_feature_counts(spec, cfg.n_features)
    r["describe_levels"] = median_ms(
        lambda: describe_levels(levels_blur, det["xy_level"], counts), device, n, warmup)
    r["build_frame(all)"] = median_ms(
        lambda: build_frame(gray_f, depth_f, spec, intr, n_features=cfg.n_features,
                            th_high=cfg.th_fast_high, th_low=cfg.th_fast_low),
        device, n, warmup)
    hv = torch.tensor(False, device=device)
    r["track_frame_step(fused)"] = median_ms(lambda: real_step(x, x["T0"], x["T0"], hv),
                                             device, n, warmup)

    tiny = torch.zeros(8, dtype=torch.float32, device=device)
    r["device_get(tiny) RTT"] = median_ms(lambda: tiny.cpu(), device, n, warmup)
    big_up = np.zeros((480, 640), np.uint8)
    r["upload 300KB u8"] = median_ms(lambda: torch.from_numpy(big_up).to(device),
                                     device, n, warmup)
    snap_up = np.zeros((4096, 8), np.float32)
    r["upload snapshot f32 128KB"] = median_ms(lambda: torch.from_numpy(snap_up).to(device),
                                               device, n, warmup)
    # detect_levels, build_frame and the fused step build one frame a call
    r["_frames"] = 1 + 3 * (n + warmup)
    return r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="per-stage medians of the tracking path")
    ap.add_argument("n", type=int, nargs="?", default=20)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    from .. import resolve_device
    from ..io.synthetic import make_sequence
    from ..tracking.tracker import TrackerConfig

    dev = resolve_device(args.device)
    print(f"device={dev}", file=sys.stderr)
    r = profile(make_sequence(n_frames=3), TrackerConfig(), dev, args.n)
    for k, v in r.items():
        if not k.startswith("_"):
            print(f"{k:32s} {v:8.2f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
