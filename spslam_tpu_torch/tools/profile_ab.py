"""A/B: the real track_frame_step against an inline replica, in
interleaved repetitions (port of tools/profile_ab.py).

The replica is the step rebuilt from its pieces: the constant-velocity
prediction, build_frame, the coarse tracking/tracker._match_and_optimize
(radius 22, or 44 without a velocity, 2x5), the global descriptor
fallback the port's step computes on every frame, the tight
_match_and_optimize (radius 6, 4x10) and tracking/tracker._pack_frame
(profile_fused.stages with every stage on).  Its out_small and out_big
equal the real step's bit for bit; the interleaving puts host noise on
both sides alike.

    python -m spslam_tpu_torch.tools.profile_ab [--device cpu] [n_per_rep] [reps]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def replica(x: dict, T_prev, T_prev2, has_vel):
    """track_frame_step's (frame, out_small, out_big) on fused_inputs x,
    point-only, from the step's pieces."""
    from ..geometry.lie import se3_compose, se3_inverse
    from .profile_fused import stages

    vel = se3_compose(T_prev, se3_inverse(T_prev2))
    T_pred = torch.where(has_vel, se3_compose(vel, T_prev), T_prev)
    r = x["cfg"].motion_search_radius
    radius1 = torch.where(has_vel, r, 2.0 * r)
    _, small, big, frame = stages(x, T_pred, radius1, T_prev, coarse=True, fallback=True,
                                  tight=True, pack=True, ret_frame=True)
    return frame, small, big


def chain(step, x: dict, n: int):
    """n chained steps (T_prev2, T_prev advance from each out_small), one
    sync at the end; seconds per step."""
    from .profile_frame import sync

    dev = x["device"]
    hv = torch.tensor(True, device=dev)
    T = T2 = x["T0"]
    t0 = time.perf_counter()
    for _ in range(n):
        _, small, _ = step(x, T, T2, hv)
        T2, T = T, small[0:7].view(torch.float32)
    sync(dev)
    return (time.perf_counter() - t0) / n


def profile(seq, cfg, device, n: int = 30, reps: int = 5):
    """(real ms per step per rep, replica ms per step per rep); builds
    2 * (1 + reps) * n frames."""
    from .profile_frame import fused_inputs, real_step

    x = fused_inputs(seq, cfg, device)
    chain(real_step, x, n)
    chain(replica, x, n)            # warm
    ra, rb = [], []
    for _ in range(reps):
        ra.append(chain(real_step, x, n) * 1e3)
        rb.append(chain(replica, x, n) * 1e3)
    return ra, rb


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="real fused step against an inline replica")
    ap.add_argument("n", type=int, nargs="?", default=30)
    ap.add_argument("reps", type=int, nargs="?", default=5)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    from .. import resolve_device
    from ..io.synthetic import make_sequence
    from ..tracking.tracker import TrackerConfig

    dev = resolve_device(args.device)
    print(f"device={dev}", file=sys.stderr)
    ra, rb = profile(make_sequence(n_frames=2), TrackerConfig(), dev, args.n, args.reps)
    print(f"real    track_frame_step: {['%.2f' % v for v in ra]}  median {np.median(ra):.2f} ms")
    print(f"replica (inline)        : {['%.2f' % v for v in rb]}  median {np.median(rb):.2f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
