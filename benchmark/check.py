"""What decides `correct`: the fused tracking steps of the window against the
plain reference (benchmark/reference/step.py).

During the window the harness keeps a sample of the program's fused steps
(`spslam_tpu_torch.tracking.tracker.track_frame_step`, the one call per
tracked frame that builds the frame and optimises its pose), drawn from the
seed by reservoir sampling over every step of the window: the program's
state that the step starts from (the two previous poses, the motion flag,
the local-map snapshot and, with planes, the map-plane snapshot) and the
two buffers it produced.  After the window the reference computes the same
step again from that state and from the frame the benchmark handed in,
and each step is judged by

    pose gap           camera-centre distance between the program's pose
                       and the reference's, mm
    feature mismatch   share of the program's keypoints (position to 1/16
                       px, depth, octave, angle bin, descriptor) that the
                       reference's frame does not hold, as multisets

Over the sample: pose_gap_mm (the worst step), pose_gap_median_mm,
feature_mismatch (the worst step).  A cell's limits file names the numbers
it compares.
"""

from __future__ import annotations

import collections
import contextlib
import inspect
from typing import List, NamedTuple

import numpy as np
import torch

from .reference import step as ref_step
from .reference.camera import Intrinsics as RefIntrinsics
from .reference.pyramid import PyramidSpec as RefSpec
from .stats import camera_centers


class Step(NamedTuple):
    """One fused step of the window, as the program ran it."""
    session: int
    frame: int
    state: dict      # T_prev, T_prev2, has_vel, pt_pack, pt_desc, pl_pack (clones)
    static: dict     # the step's scalar settings as the program passed them
    out_small: torch.Tensor
    out_big: torch.Tensor


STATE_ARGS = ("T_prev", "T_prev2", "has_vel", "pt_pack", "pt_desc", "pl_pack")
STATIC_ARGS = ("radius_motion", "radius2", "th_depth", "spec", "intr", "n_features",
               "th_high", "th_low", "depth_factor", "plane_info", "plane_assoc_cos",
               "plane_assoc_dist", "plane_min_support")


class Capture:
    """Keeps a seeded uniform sample of `size` fused steps of the window.
    `current` is the (session, frame) the harness is handing in; the step
    of a `track_rgbd` call is that frame's."""

    def __init__(self, seed: int, size: int):
        self.rng = np.random.default_rng([int(seed) % (1 << 63), 7])
        self.size = size
        self.seen = 0
        self.steps: List[Step] = []
        self.active = False
        self.current = (-1, -1)
        self._orig = None

    def install(self):
        """Wrap the program's fused step (undone by `remove`)."""
        from spslam_tpu_torch.tracking import tracker

        orig = self._orig = tracker.track_frame_step
        sig = inspect.signature(orig)

        def hooked(*args, **kw):
            out = orig(*args, **kw)
            if self.active:
                self._offer(sig.bind(*args, **kw), out)
            return out

        tracker.track_frame_step = hooked

    def remove(self):
        from spslam_tpu_torch.tracking import tracker

        if self._orig is not None:
            tracker.track_frame_step = self._orig
            self._orig = None

    def _offer(self, bound, out):
        self.seen += 1
        if len(self.steps) < self.size:
            slot = len(self.steps)
            self.steps.append(None)
        else:
            slot = int(self.rng.integers(0, self.seen))
            if slot >= self.size:
                return
        bound.apply_defaults()
        a = bound.arguments
        state = {k: (None if a[k] is None else a[k].clone()) for k in STATE_ARGS}
        static = {k: (tuple(a[k]) if isinstance(a[k], tuple) else a[k]) for k in STATIC_ARGS}
        self.steps[slot] = Step(*self.current, state, static, out[1].clone(), out[2].clone())


def stated_static(config: dict) -> dict:
    """The step's scalar settings as the configuration states them."""
    t, c = config["tracker"], config["camera"]
    intr = RefIntrinsics(**c)
    spec = RefSpec(t["n_levels"], t["scale_factor"], c["height"], c["width"])
    return dict(
        radius_motion=t["motion_search_radius"], radius2=t["local_search_radius"],
        th_depth=t["th_depth"], spec=tuple(spec), intr=tuple(intr), n_features=t["n_features"],
        th_high=t["th_fast_high"], th_low=t["th_fast_low"],
        depth_factor=config["system"]["depth_map_factor"], plane_info=t["plane_info"],
        plane_assoc_cos=t["plane_assoc_cos"], plane_assoc_dist=t["plane_assoc_dist"],
        plane_min_support=t["plane_min_support"],
    )


@contextlib.contextmanager
def matmul_tf32(on: bool):
    """float32 matmuls in TF32 (on) or in full float32 (off), restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def reference_step(s: Step, gray: np.ndarray, depth: np.ndarray, config: dict, device):
    """The reference's (out_small, out_big) for step s, from the frame the
    benchmark handed in (u8 gray, u16 depth) and the program's state."""
    st = stated_static(config)
    stride = config["tracker"]["depth_upload_stride"]
    d = np.ascontiguousarray(depth[::stride, ::stride]).view(np.int16)
    _, small, big = ref_step.track_frame_step(
        torch.from_numpy(np.ascontiguousarray(gray)).to(device), torch.from_numpy(d).to(device),
        s.state["T_prev"], s.state["T_prev2"], s.state["has_vel"], s.state["pt_pack"],
        s.state["pt_desc"], st["radius_motion"], st["radius2"], st["th_depth"],
        RefSpec(*st["spec"]), RefIntrinsics(*st["intr"]), st["n_features"],
        st["th_high"], st["th_low"], depth_factor=st["depth_factor"],
        pl_pack=s.state["pl_pack"], plane_info=st["plane_info"],
        plane_assoc_cos=st["plane_assoc_cos"], plane_assoc_dist=st["plane_assoc_dist"],
        plane_min_support=st["plane_min_support"],
    )
    return small, big


def _rows(big: np.ndarray, n: int) -> collections.Counter:
    """The valid keypoints of an out_big buffer as a multiset of
    (w0, w1, descriptor words)."""
    w0, w1, desc = big[:n], big[n:2 * n], big[2 * n:].reshape(n, 8)
    valid = ((w1 >> 16) & 0x80) != 0
    return collections.Counter((int(w0[i]), int(w1[i]), desc[i].tobytes())
                               for i in np.nonzero(valid)[0])


def compare(small: torch.Tensor, big: torch.Tensor, ref_small: torch.Tensor,
            ref_big: torch.Tensor, n_features: int) -> tuple:
    """(pose gap mm, feature mismatch share) of one step's buffers against
    the reference's."""
    T = small[:7].view(torch.float32).cpu().numpy().astype(np.float64)[None]
    T_ref = ref_small[:7].view(torch.float32).cpu().numpy().astype(np.float64)[None]
    gap = float(np.linalg.norm(camera_centers(T) - camera_centers(T_ref))) * 1e3
    if not np.isfinite(gap):
        gap = float("inf")
    got = _rows(big.cpu().numpy().view(np.uint32), n_features)
    want = _rows(ref_big.cpu().numpy().view(np.uint32), n_features)
    n = max(sum(got.values()), sum(want.values()), 1)
    return gap, 1.0 - sum((got & want).values()) / n


class Readings(NamedTuple):
    pose_gaps_mm: list   # per step
    mismatches: list     # per step
    departures: list     # settings the program ran with that the configuration does not state

    def numbers(self) -> dict:
        g = sorted(self.pose_gaps_mm)
        return {"pose_gap_mm": g[-1] if g else None,
                "pose_gap_median_mm": float(np.median(g)) if g else None,
                "feature_mismatch": max(self.mismatches, default=None),
                "steps": len(g)}


def reference_outputs(steps: List[Step], sessions, config: dict, device,
                      tf32: bool = False) -> list:
    """The reference's (out_small, out_big) for every step, its float32
    matmuls in full float32, or in TF32: the control."""
    out = []
    for s in steps:
        sess = sessions[s.session % len(sessions)]
        with matmul_tf32(tf32):
            out.append(reference_step(s, sess.gray[s.frame], sess.depth[s.frame], config, device))
    return out


def readings(steps: List[Step], judged: list, refs: list, config: dict) -> Readings:
    """Per step, the buffers `judged` (one (out_small, out_big) per step)
    against the reference's `refs`."""
    stated = stated_static(config)
    departures = sorted({(k, s.static[k]) for s in steps for k, v in stated.items()
                         if s.static[k] != v}, key=str)
    pairs = [compare(*j, *r, config["tracker"]["n_features"]) for j, r in zip(judged, refs)]
    return Readings([g for g, _ in pairs], [m for _, m in pairs], departures)


def judge(steps: List[Step], sessions, config: dict, device) -> Readings:
    """The program's steps against the reference."""
    refs = reference_outputs(steps, sessions, config, device)
    return readings(steps, [(s.out_small, s.out_big) for s in steps], refs, config)


def verdict(r: Readings, limits: dict) -> tuple:
    """(correct, {number: {value, limit}}): every number that the cell's
    limits name, the count of steps compared against min_steps, and the
    settings the program departed from the configuration in (none allowed)."""
    nums = r.numbers()
    checks = {k: {"value": nums[k], "limit": limits[k]} for k in nums if k in limits}
    checks["steps"] = {"value": nums["steps"], "limit": limits["min_steps"]}
    checks["departures"] = {"value": len(r.departures), "limit": 0}
    ok = (nums["steps"] >= limits["min_steps"] and not r.departures
          and all(v["value"] is not None and v["value"] <= v["limit"]
                  for k, v in checks.items() if k != "steps"))
    return ok, checks
