"""Whole-System runs of spslam_tpu and the port on the CPU, for the
reference numbers PERF.md records (not a test: tier-1 runs
tests/test_torch_system_planes.py and tests/test_torch_lowtex.py).

    python -m tests.torch_cpu_runs lowtex [--feed u8|float] [--threads N] [--which jax,port]
    python -m tests.torch_cpu_runs planes15

lowtex: the planes lane's 30 frames (seed 7, 0.8% depth noise, local BA,
pipeline depth 2, th_depth 3.2 as tests/integration/test_slam_lowtexture.py),
each package with planes on and off.  `--feed u8` feeds u8 gray and u16
depth as chip_smoke.py does, `float` the float gray and meters of the
integration test.  planes15: the 15-frame orbit with planes
(tests/integration/test_slam_planes.py), u8 feed.  Prints one JSON line
per System: package, planes on/off, ATE, LOST frames, keyframes, map
planes.
"""

import argparse
import json
import time

import numpy as np
import torch


def _system(pkg, intr, use_planes, lowtex):
    if pkg == "jax":
        from spslam_tpu.geometry.camera import Intrinsics
        from spslam_tpu.system import System, SystemConfig
        from spslam_tpu.tracking.tracker import TrackerConfig
        intr = Intrinsics(*intr)
        dev = {}
    else:
        from spslam_tpu_torch.system import System, SystemConfig
        from spslam_tpu_torch.tracking.tracker import TrackerConfig
        dev = dict(device="cpu")
    tracker = TrackerConfig(th_depth=3.2, pipeline_depth=2) if lowtex else TrackerConfig()
    return System(SystemConfig(intr=intr, local_ba=True, use_planes=use_planes,
                               enable_reloc=False, tracker=tracker), **dev)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("run", choices=("lowtex", "planes15"))
    ap.add_argument("--feed", choices=("u8", "float"), default="u8")
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--which", default="jax,port")
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    from spslam_tpu_torch.eval.ate import ate_rmse
    from spslam_tpu_torch.io.synthetic import make_sequence

    lowtex = args.run == "lowtex"
    if lowtex:
        seq = make_sequence(n_frames=30, low_texture=True, depth_noise=0.008, seed=7)
    else:
        seq = make_sequence(n_frames=15)
    frames = seq.frames
    if args.feed == "u8":
        frames = [(np.clip(g, 0, 255).astype(np.uint8),
                   np.clip(d * 5000.0, 0, 65535).astype(np.uint16)) for g, d in frames]
    for pkg in args.which.split(","):
        for use_planes in ((True, False) if lowtex else (True,)):
            t0 = time.perf_counter()
            s = _system(pkg, seq.intr, use_planes, lowtex)
            for (gray, depth), ts in zip(frames, seq.timestamps):
                s.track_rgbd(gray, depth, ts)
            s.shutdown()
            ate = ate_rmse(s.poses(), seq.poses_gt)[0]
            print(json.dumps(dict(
                run=args.run, package=pkg, planes=use_planes, feed=args.feed,
                threads=args.threads, ate_mm=round(float(ate) * 1e3, 3),
                lost=sum(1 for m in s.tracker.metrics if m["state"] == "LOST"),
                keyframes=int(s.store.n_kf), map_planes=int(s.store.pl_valid.sum()),
                seconds=round(time.perf_counter() - t0, 1))), flush=True)


if __name__ == "__main__":
    main()
