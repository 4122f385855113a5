"""Data-parallel evaluation of several sequences (port of
spslam_tpu/parallel/dp_eval.py).

Each sequence owns an independent map, so the evaluation is data-parallel
with nothing to synchronize: one full System per sequence, each built with
its own explicit device, frames fed round-robin (frame t of every sequence
before frame t+1 of any) so the devices work concurrently; the only
"collective" is the host-side gather of the per-sequence metrics.  With
more sequences than devices, Systems share devices round-robin (on one
H100 they all share cuda:0).

    results, fps = evaluate_sequences([make_sequence(seed=s) for s in (0, 7)])
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import torch

from .. import resolve_device
from ..eval.ate import ate_rmse


@dataclass
class SeqResult:
    name: str
    device: str
    n_frames: int
    ate_rmse_m: float
    wall_s: float          # whole-batch wall clock (identical across results)
    fps_aggregate: float   # batch frames/sec across the whole run
    n_kf: int
    n_pts: int
    states: List[str] = field(default_factory=list)


def evaluate_sequences(sequences, make_system: Optional[Callable[[int, torch.device], object]] = None,
                       devices=None, names: Optional[Sequence[str]] = None):
    """Run one System per sequence, sequence i on devices[i % len(devices)]
    (default: every visible CUDA device), frames interleaved round-robin.

    sequences: SyntheticSequence-like objects (`.frames` [(gray, depth)],
    `.timestamps`, `.poses_gt`, `.intr`).  make_system: optional factory
    `(i, device) -> System` (default: a point-only System with the
    sequence's intrinsics on that device).

    Systems must map synchronously (`async_mapping=False`): the current
    CUDA device is thread-local, so a background mapping thread is a
    second place where a System's work could leave the device it was
    pinned to (asserted below).

    Returns (results, aggregate_fps)."""
    from ..system import System, SystemConfig

    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            resolve_device(None)   # raises: CUDA asked for and absent
    devices = [resolve_device(d) for d in devices]
    names = list(names or [f"seq{i}" for i in range(len(sequences))])

    systems = []
    for i, seq in enumerate(sequences):
        dev = devices[i % len(devices)]
        if make_system is not None:
            sys_i = make_system(i, dev)
        else:
            sys_i = System(SystemConfig(intr=seq.intr), device=dev)
        assert not sys_i.cfg.async_mapping, (
            "dp_eval requires async_mapping=False: the current CUDA device is "
            "thread-local, so a background mapper would bypass device pinning")
        systems.append((sys_i, dev, seq))

    n_total = sum(len(s.frames) for s in sequences)
    max_len = max(len(s.frames) for s in sequences)
    t0 = time.perf_counter()
    for t in range(max_len):
        for sys_i, _, seq in systems:
            if t < len(seq.frames):
                gray, depth = seq.frames[t]
                sys_i.track_rgbd(gray, depth, float(seq.timestamps[t]))
    for sys_i, _, _ in systems:
        sys_i.shutdown()
    for dev in {d for _, d, _ in systems if d.type == "cuda"}:
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    agg_fps = n_total / wall if wall > 0 else float("inf")

    results = []
    for (sys_i, dev, seq), name in zip(systems, names):
        poses = sys_i.poses()
        n = min(len(poses), len(seq.poses_gt))
        ate, _ = ate_rmse(poses[:n], seq.poses_gt[:n])
        results.append(SeqResult(
            name=name, device=str(dev), n_frames=len(seq.frames), ate_rmse_m=ate,
            wall_s=wall, fps_aggregate=agg_fps,
            n_kf=int(sys_i.store.kf_valid.sum()), n_pts=int(sys_i.store.pt_valid.sum()),
            states=[m["state"] for m in sys_i.tracker.metrics],
        ))
    return results, agg_fps
