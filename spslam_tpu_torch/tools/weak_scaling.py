"""Fixed-total-work scaling study of the sharded bundle adjustment (port of
tools/weak_scaling.py).

One problem (64 cameras, points_per_shard x the largest D points, each
seen by 4 random cameras; seed 0) is split into D in {1, 2, 4, 8} <=
--devices shards (`partition_problem(..., strategy="segments")`) and solved
by `dist_bundle_adjust` for --iters LM iterations, the shards placed
round-robin on the visible devices.  The compute is the same at every D,
so the ideal time is flat: growth over D = 1 is collective + partition-
imbalance overhead.  Times are the mean of 3 solves after a warm-up solve,
between `torch.cuda.synchronize()` fences.

With fewer cards than D the shards share a card: the overhead then
measures shards taking turns on one card, not collectives (a caveat line
says so before the JSON line).

    python -m spslam_tpu_torch.tools.weak_scaling [--devices 8]
        [--points-per-shard 4096] [--cams 64] [--iters 10] [--device cpu]

The last line is one JSON object: dist_ba_comm_overhead_frac (value),
devices, weak_scaling_efficiency_estimate, ba_iters_per_sec_1dev.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..geometry.camera import Intrinsics

INTR = Intrinsics(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0)


def make_problem(n_pts: int, n_cams: int = 64, seed: int = 0, intr: Intrinsics = INTR):
    """(poses [C, 7], fixed [C], points [P, 3], obs_cam, obs_pt, obs_uv,
    obs_ur): cameras stepping along x with a slow yaw, points in a box in
    front of them, every point observed by 4 random cameras (exact
    observations; the ones behind a camera dropped).  Host numpy, built
    with the port's geometry ops on the CPU."""
    from ..geometry.camera import project
    from ..geometry.lie import se3_apply, se3_exp

    rng = np.random.default_rng(seed)
    poses = np.stack([
        se3_exp(torch.tensor([0.05 * i, 0, 0, 0, 0.01 * i, 0], dtype=torch.float32)).numpy()
        for i in range(n_cams)
    ])
    pts = np.stack([
        rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts), rng.uniform(3, 9, n_pts)
    ], -1).astype(np.float32)
    obs_cam = rng.integers(0, n_cams, n_pts * 4).astype(np.int32)
    obs_pt = np.repeat(np.arange(n_pts, dtype=np.int32), 4)
    xc = se3_apply(torch.from_numpy(poses[obs_cam]), torch.from_numpy(pts[obs_pt])).numpy()
    uv = project(intr, torch.from_numpy(xc)).numpy()
    ur = uv[:, 0] - intr.bf / np.maximum(xc[:, 2], 0.1)
    ok = (xc[:, 2] > 0.2) & (uv[:, 0] > -1e4) & (uv[:, 0] < 1e4)
    fixed = np.zeros(n_cams, bool)
    fixed[0] = True
    return (poses, fixed, pts, obs_cam[ok], obs_pt[ok],
            uv[ok].astype(np.float32), ur[ok].astype(np.float32))


def _sync(devices):
    for d in {d for d in devices if d.type == "cuda"}:
        torch.cuda.synchronize(d)


def sweep(problem, dev_counts, visible, iters: int = 10, reps: int = 3,
          intr: Intrinsics = INTR) -> list[dict]:
    """Solve `problem` split into each D of dev_counts; per D: n_pts, dt
    (s per solve), iters_per_sec, cost0 (before) and cost (after)."""
    from ..parallel.dist_ba import dist_bundle_adjust, partition_problem

    poses, fixed, pts, oc, op, ouv, our = problem
    results = []
    for D in dev_counts:
        prob = partition_problem(poses, fixed, pts, oc, op, ouv, our,
                                 np.ones(len(oc), np.float32), D, strategy="segments")
        devices = [visible[i % len(visible)] for i in range(D)]
        cost0 = float(dist_bundle_adjust(prob, intr, devices, n_iters=0)[2])
        out = dist_bundle_adjust(prob, intr, devices, n_iters=iters)   # warm-up
        _sync(devices)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = dist_bundle_adjust(prob, intr, devices, n_iters=iters)
            _sync(devices)
        dt = (time.perf_counter() - t0) / reps
        results.append(dict(D=D, n_pts=len(pts), dt=dt, iters_per_sec=iters / dt,
                            cost0=cost0, cost=float(out[2])))
        print(f"D={D}: {len(pts)} pts, {dt * 1000:.0f} ms / {iters} LM iters "
              f"({iters / dt:.1f} iters/s), cost {cost0:.6g} -> {float(out[2]):.6g}")
    return results


def summarize(results, n_visible: int) -> dict:
    """Print the t/t1 table (and the caveat when shards shared a device)
    and return the JSON line's object."""
    base = results[0]["dt"]
    print("\nfixed-total-work sweep (ideal = flat; growth = comm/imbalance overhead):")
    for r in results:
        print(f"  D={r['D']}: t/t1 = {r['dt'] / base:.2f}  "
              f"(overhead {max(r['dt'] / base - 1, 0) * 100:.0f}%)")
    last = results[-1]
    if last["D"] > n_visible:
        print(f"caveat: {n_visible} device(s) for up to {last['D']} shards; shards share a "
              f"device, so the overhead measures them taking turns on it, not collectives")
    # on real hardware compute shrinks by D per chip while the overhead
    # stays, so efficiency ~ 1 / (1 + overhead)
    overhead = max(last["dt"] / base - 1.0, 0.0)
    return {
        "metric": "dist_ba_comm_overhead_frac",
        "value": round(overhead, 3),
        "unit": "fraction_of_compute",
        "devices": last["D"],
        "weak_scaling_efficiency_estimate": round(1.0 / (1.0 + overhead), 3),
        "ba_iters_per_sec_1dev": round(results[0]["iters_per_sec"], 2),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="fixed-total-work sweep of the sharded BA")
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--points-per-shard", type=int, default=4096)
    ap.add_argument("--cams", type=int, default=64)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device for every shard (default: the visible CUDA cards)")
    args = ap.parse_args(argv)

    from ..parallel.dist_ba import global_mesh

    visible = global_mesh(args.device)
    dev_counts = [d for d in (1, 2, 4, 8) if d <= args.devices]
    problem = make_problem(args.points_per_shard * max(dev_counts), args.cams)
    results = sweep(problem, dev_counts, visible, args.iters)
    print(json.dumps(summarize(results, len(visible))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
