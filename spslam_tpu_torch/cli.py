"""Command line: run the SLAM system on a sequence and report ATE and
timing (port of spslam_tpu/cli.py, the reference's rgbd_tum.cc).

Loads a TUM-layout sequence (or renders the built-in synthetic one), tracks
every frame, prints per-frame timing, saves trajectories and, with ground
truth, prints the ATE RMSE and a final JSON line.  Runs on CUDA; --cpu
runs the port on the CPU.

  python -m spslam_tpu_torch.cli --synthetic --frames 30 [--planes] [--no-ba]
  python -m spslam_tpu_torch.cli --tum /path/to/sequence [--config configs/tum1.yaml]
  python -m spslam_tpu_torch.cli --tum DIR --loop --async-mapping
  python -m spslam_tpu_torch.cli --dp 4 --frames 30
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description="point+plane RGB-D SLAM (PyTorch/CUDA)")
    ap.add_argument("--synthetic", action="store_true", help="use the built-in synthetic room sequence")
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--tum", type=str, default=None, help="TUM RGB-D sequence directory")
    ap.add_argument("--config", type=str, default=None, help="YAML camera/ORB config")
    ap.add_argument("--planes", action="store_true", help="enable plane landmarks")
    ap.add_argument("--no-ba", action="store_true", help="disable local BA")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of CUDA")
    ap.add_argument("--traj-out", type=str, default="trajectory_tum.txt")
    ap.add_argument("--metrics-out", type=str, default=None)
    ap.add_argument("--map-out", type=str, default=None)
    ap.add_argument("--loop", action="store_true", help="enable loop closing")
    ap.add_argument("--async-mapping", action="store_true", help="background mapping thread")
    ap.add_argument(
        "--dp", type=int, default=0, metavar="N",
        help="data-parallel batch evaluation: run N synthetic sequences "
             "concurrently, one System per device (round-robin)",
    )
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None

    if args.dp > 0:
        from .io.synthetic import make_sequence
        from .parallel.dp_eval import evaluate_sequences

        n = args.dp
        print(f"rendering {n} synthetic sequences ({args.frames} frames each)...")
        seqs = [make_sequence(n_frames=args.frames, seed=7 * i) for i in range(n)]
        devs = ([torch.device("cpu")] if args.cpu else
                [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
        print(f"evaluating on {min(n, max(len(devs), 1))} of {len(devs)} devices...")
        results, agg_fps = evaluate_sequences(seqs, devices=devs or None)
        for r in results:
            print(f"  {r.name} @ {r.device}: ATE {r.ate_rmse_m*1000:.2f} mm, "
                  f"{r.n_kf} kfs, {r.n_pts} pts")
        print(json.dumps({
            "dp_sequences": n,
            "aggregate_fps": agg_fps,
            "ate_rmse_m": [r.ate_rmse_m for r in results],
        }))
        return

    from .eval.ate import ate_rmse
    from .system import System, SystemConfig

    if args.synthetic or not args.tum:
        from .io.synthetic import make_sequence

        print(f"rendering synthetic sequence ({args.frames} frames)...")
        seq = make_sequence(n_frames=args.frames)
    else:
        from .io.tum import load_tum_sequence

        seq = load_tum_sequence(args.tum, config_yaml=args.config)
    frames, timestamps, intr, poses_gt = seq.frames, seq.timestamps, seq.intr, seq.poses_gt

    if args.config:
        from .config import system_config_from_yaml

        cfg = system_config_from_yaml(
            args.config, local_ba=not args.no_ba, use_planes=args.planes,
            use_loop=args.loop, async_mapping=args.async_mapping,
        )
        cfg.intr = intr if args.synthetic or not args.tum else cfg.intr
    else:
        cfg = SystemConfig(
            intr=intr, local_ba=not args.no_ba, use_planes=args.planes,
            use_loop=args.loop, async_mapping=args.async_mapping,
        )
    sys_ = System(cfg, device=device)

    times = []
    for i, ((gray, depth), ts) in enumerate(zip(frames, timestamps)):
        t0 = time.perf_counter()
        _, state = sys_.track_rgbd(gray, depth, ts)
        dt = time.perf_counter() - t0
        times.append(dt)
        if i % 10 == 0:
            print(f"frame {i}: state={state.name} {dt*1000:.1f}ms")
    sys_.shutdown()

    times = np.array(times[2:])  # skip the first (warm-up) frames
    print(f"\ntracked {len(frames)} frames | median {np.median(times)*1000:.1f} ms/frame "
          f"({1.0/np.median(times):.1f} fps) | mean {times.mean()*1000:.1f} ms")
    print(f"map: {sys_.store.n_kf} keyframes, {int(sys_.store.pt_valid.sum())} points, "
          f"{int(sys_.store.pl_valid.sum())} planes")

    sys_.save_trajectory_tum(args.traj_out)
    print(f"trajectory saved to {args.traj_out}")
    if args.metrics_out:
        sys_.save_metrics(args.metrics_out)
    if args.map_out:
        sys_.save_map(args.map_out)

    if poses_gt is not None:
        est = sys_.poses()
        rmse, _ = ate_rmse(est, poses_gt[: len(est)])
        print(f"ATE RMSE: {rmse*1000:.2f} mm")
        print(json.dumps({"ate_rmse_m": rmse, "median_ms": float(np.median(times) * 1000)}))


if __name__ == "__main__":
    main()
