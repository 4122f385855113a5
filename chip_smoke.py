#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spslam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the port's CUDA kernel (csrc/fast_nms.cu) with nvcc.
2. Kernel phase: the FAST+NMS kernel against its plain PyTorch version
   (nms3x3(fast_score_map(img))) on the card, at every level shape of the
   640x480 8-level pyramid and at (101, 131): bit-exact inside the 19-px
   detection border.  Times both: device time from the CUDA profiler,
   and CUDA-event time around single calls (median of 60).
3. Frame phase: build_frame of one frame on the card against the CPU.
4. Path phase: the port's System (point-only tracking + local BA) on a
   20-frame 640x480 synthetic sequence, 1024 features, 8 levels, from the
   entry point a user calls; asserts no LOST frame, ATE < 0.02 m and that
   every frame through the fused step launched the kernel at all 8 levels.
5. Prints the kernel table as one JSON line, the card's name and power
   limit, and as the last line {"ok": true, "device": {...}}.

Exits non-zero (and prints no result) without CUDA, or when any phase
fails.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (NVIDIA data sheet)
BORDER = 19                 # detect_levels' detection border


def _card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60,
    )
    return res.stdout.strip() or f"nvidia-smi failed: {res.stderr.strip()}"


def _image(h, w, seed):
    """Smooth blobs + noise: realistic corner density at several scales."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w), np.float32)
    for _ in range(24):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        s = rng.uniform(2, 18)
        a = rng.uniform(30, 120)
        img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    img += rng.normal(0, 4.0, (h, w))
    return np.clip(img, 0, 255).astype(np.float32)


def _timed_ms(fn, n=60, warmup=5):
    """(device ms per call, event ms per call).

    Device time is the sum of the call's kernel durations from the CUDA
    profiler (CUPTI); event time is the median of CUDA-event pairs around
    single calls, which also holds the host's launch latency whenever the
    kernels are shorter than it.  Device time is None if the profiler
    reports none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(
        float(getattr(ev, "self_device_time_total", 0.0) or 0.0)
        for ev in prof.key_averages() if "CUDA" in str(ev.device_type)
    )
    return (dev_us / 1e3 / n if dev_us > 0 else None), float(np.median(times))


def kernel_phase(spec):
    import torch

    from spslam_tpu_torch.ops import fast_cuda
    from spslam_tpu_torch.ops.fast import fast_score_map, nms3x3

    rows = []
    shapes = list(spec.level_sizes) + [(101, 131)]
    for (h, w) in shapes:
        img = torch.from_numpy(_image(h, w, seed=h * 1000 + w)).cuda()
        got = fast_cuda.fast_nms_scores_cuda(img, 7.0, 20.0)
        want = nms3x3(fast_score_map(img, 7.0, 20.0))
        torch.cuda.synchronize()
        inner = (slice(BORDER, h - BORDER), slice(BORDER, w - BORDER))
        err = float((got[inner] - want[inner]).abs().max())
        n_diff = int((got[inner] != want[inner]).sum())
        n_corner = int((want[inner] > 0).sum())
        if n_diff:
            raise AssertionError(f"fast_nms kernel differs from plain at {n_diff} px "
                                 f"inside the border of {h}x{w} (max abs {err})")
        k_dev, k_ev = _timed_ms(lambda: fast_cuda.fast_nms_scores_cuda(img, 7.0, 20.0))
        p_dev, p_ev = _timed_ms(lambda: nms3x3(fast_score_map(img, 7.0, 20.0)))
        bound_ms = h * w * 8 / HBM_BYTES_PER_S * 1e3
        # device time where the profiler gives it, else the event time
        rows.append(dict(shape=(h, w), err=err, corners=n_corner,
                         ms=k_dev if k_dev is not None else k_ev,
                         plain_ms=p_dev if p_dev is not None else p_ev, bound_ms=bound_ms))
        fmt = lambda x: "n/a" if x is None else f"{x * 1e3:8.2f}"  # noqa: E731
        print(f"  fast_nms {h:4d}x{w:<4d} corners={n_corner:5d} max_abs_err={err} "
              f"kernel device {fmt(k_dev)} us (event {fmt(k_ev)})  "
              f"plain device {fmt(p_dev)} us (event {fmt(p_ev)})  bound {bound_ms * 1e3:6.3f} us")
    return rows


def frame_phase(seq):
    """build_frame of one frame on the card against the CPU."""
    import torch

    from spslam_tpu_torch.frontend.frame import build_frame
    from spslam_tpu_torch.ops.pyramid import PyramidSpec

    gray, depth = seq.frames[3]
    spec = PyramidSpec(8, 1.2, seq.intr.height, seq.intr.width)
    out = {}
    for dev in ("cuda", "cpu"):
        f = build_frame(torch.from_numpy(gray).to(dev), torch.from_numpy(depth).to(dev),
                        spec, seq.intr, n_features=1024)
        out[dev] = {k: getattr(f, k).cpu().numpy() for k in ("uv", "valid", "desc", "depth")}
    g, c = out["cuda"], out["cpu"]
    if g["uv"].shape != (1024, 2) or not np.isfinite(g["uv"]).all():
        raise AssertionError(f"build_frame on the card: bad uv {g['uv'].shape}")
    same_kp = float(np.mean(np.all(g["uv"] == c["uv"], axis=1) & (g["valid"] == c["valid"])))
    same_desc = float(np.mean(np.all(g["desc"] == c["desc"], axis=1)))
    print(f"  build_frame cuda vs cpu: keypoints equal {same_kp:.4f}, "
          f"descriptors equal {same_desc:.4f}, valid {int(g['valid'].sum())}")
    if same_kp < 0.99 or same_desc < 0.97:
        raise AssertionError("build_frame on the card disagrees with the CPU")


def path_phase(seq):
    import torch

    from spslam_tpu_torch.eval.ate import ate_rmse
    from spslam_tpu_torch.ops import fast_cuda
    from spslam_tpu_torch.system import System, SystemConfig
    from spslam_tpu_torch.tracking.tracker import TrackState

    frames = [
        (np.clip(g, 0, 255).astype(np.uint8), np.clip(d * 5000.0, 0, 65535).astype(np.uint16))
        for g, d in seq.frames
    ]
    sys_ = System(SystemConfig(intr=seq.intr, local_ba=True, enable_reloc=False),
                  device="cuda")
    fast_cuda.LAUNCHES = 0
    times = []
    t_all = time.perf_counter()
    for (gray, depth), ts in zip(frames, seq.timestamps):
        t0 = time.perf_counter()
        sys_.track_rgbd(gray, depth, ts)
        times.append(time.perf_counter() - t0)
    sys_.shutdown()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_all
    launches = fast_cuda.LAUNCHES
    n_fused = sys_.tracker.n_fused

    poses = sys_.poses()
    ate, _ = ate_rmse(poses, seq.poses_gt)
    n_lost = sum(1 for m in sys_.tracker.metrics if m["state"] == "LOST")
    steady_ms = float(np.median(times[5:])) * 1e3
    print(f"  path: {len(frames)} frames, fused {n_fused}, kernel launches {launches}, "
          f"LOST {n_lost}, state {sys_.tracker.state.name}, keyframes {sys_.store.n_kf}, "
          f"points {int(sys_.store.pt_valid.sum())}")
    print(f"  path: median steady {steady_ms:.3f} ms/frame (track_rgbd, frames 5..), "
          f"wall {wall * 1e3 / len(frames):.3f} ms/frame incl. shutdown, "
          f"ATE {ate * 1e3:.3f} mm")
    if poses.shape != (len(frames), 7) or not np.isfinite(poses).all():
        raise AssertionError(f"bad trajectory {poses.shape}")
    if n_lost or sys_.tracker.state != TrackState.OK:
        raise AssertionError(f"tracking lost: {n_lost} LOST, final {sys_.tracker.state}")
    if sys_.store.n_kf < 2:
        raise AssertionError(f"only {sys_.store.n_kf} keyframes")
    if not ate < 0.02:
        raise AssertionError(f"ATE {ate} m >= 0.02 m")
    if n_fused == 0 or launches < 8 * n_fused:
        raise AssertionError(f"kernel launched {launches} times for {n_fused} fused frames")
    return dict(launches=launches, n_fused=n_fused, ate=ate, steady_ms=steady_ms)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from spslam_tpu_torch.io.synthetic import make_sequence
    from spslam_tpu_torch.ops import fast_cuda
    from spslam_tpu_torch.ops.pyramid import PyramidSpec

    card = _card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    fast_cuda.build(verbose=True)
    print(f"kernel build {time.perf_counter() - t0:.2f} s")

    spec = PyramidSpec(n_levels=8, scale_factor=1.2, height=480, width=640)
    print("kernel phase")
    rows = kernel_phase(spec)
    t0 = time.perf_counter()
    seq = make_sequence(n_frames=20)
    print(f"rendered 20 frames in {time.perf_counter() - t0:.1f} s")
    print("frame phase")
    frame_phase(seq)
    print("path phase")
    path = path_phase(seq)

    level = [r for r in rows if r["shape"] in set(spec.level_sizes)]
    kernels = [dict(
        name="fast_nms", route="cuda", source="spslam_tpu_torch/csrc/fast_nms.cu",
        replaces="spslam_tpu/ops/fast_pallas.py:99",
        launches=path["launches"],
        max_abs_err=max(r["err"] for r in rows),
        # per frame: the 8 level launches of one pyramid
        ms=sum(r["ms"] for r in level),
        plain_ms=sum(r["plain_ms"] for r in level),
        bound_ms=sum(r["bound_ms"] for r in level),
        bound_by="bytes",
        library_ms=None,
    )]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
