"""A run's loop closures against the plain reference
(benchmark/reference/pose_graph.py).

`Capture` keeps, for every closure the program makes, the essential-graph
problem it solved (the `PoseGraphProblem` handed to `optimize_pose_graph`
inside `LoopCloser._optimize_graph`, at `MapConfig.max_keyframes` slots)
with its answer, and the map's state around `LoopCloser._correct_points`:
the poses before the closure and after the solve, and each valid point
before and after its correction.  `gaps` holds each closure
against the reference on three numbers:

    step_gap    one Gauss-Newton step of the problem, by the program's
                `optimize_pose_graph` and by the reference: the largest
                camera-centre distance between their keyframes over the
                largest camera-centre move of the program's step
    pose_gap    the same for the whole solve: the program's answer, as
                the timed path computed it, against the reference's, over
                the largest move of the program's solve (the correction)
    point_gap   the program's corrected points against the reference's
                point correction applied with the program's solved poses:
                the largest distance over the largest move of a point

Their tolerances, and why.  STEP_TOL 5e-5: one step is a linear solve
in float32, decided to a few float32 roundings times the system's
condition; on chip_smoke's drifted loops of 16-32 keyframes (seeds 10-12,
CPU) it reads 1.2e-6 to 9.6e-6, and with the reference's normal
equations in TF32 (the control) 2.3e-4 to 6.2e-4.  SOLVE_TOL 3.5e-4,
about the square root of float32's epsilon: the accept rule compares two
float32 costs, so the last steps of a converged solve, which change the
cost by less than its rounding, are accepted or rejected by the rounding
of each implementation's sums, and a step of size s changes the cost by
~s^2; the same loops read 3.2e-6 to 8.8e-5 (TF32: 5.9e-5 to 2.9e-4, so
the whole solve cannot tell the control apart, and the first step does).
POINT_TOL 1e-5: the correction is a few float32 operations a point.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from .reference import pose_graph as ref
from .stats import camera_centers

STEP_TOL = 5e-5      # of the largest keyframe move of one step
SOLVE_TOL = 3.5e-4   # of the largest keyframe move of the solve
POINT_TOL = 1e-5     # of the largest point move

PROBLEM_FIELDS = ("poses", "fixed", "valid", "edge_i", "edge_j", "edge_T", "edge_w",
                  "edge_valid")


class Closure(NamedTuple):
    problem: dict            # PROBLEM_FIELDS as numpy arrays
    n_iters: int
    solved: np.ndarray       # [K, 7] the program's optimize_pose_graph output
    old_poses: np.ndarray    # [K, 7] the keyframe poses before the closure
    kf_pose: np.ndarray      # [K, 7] the store's poses at the correction
    kf_valid: np.ndarray     # [K]
    pt_ids: np.ndarray       # the valid points at the correction
    ref_kf: np.ndarray       # their reference keyframes
    before: np.ndarray       # [N, 3] their positions before ...
    after: np.ndarray        # ... and after the program's correction


def _numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().copy()


class Capture:
    """Records every closure of the program's LoopClosers while installed
    (undone by `remove`)."""

    def __init__(self):
        self.closures: List[Closure] = []
        self._solve = None
        self._orig = None

    def install(self):
        from spslam_tpu_torch.loop import loop_closer

        self._orig = (loop_closer.optimize_pose_graph, loop_closer.LoopCloser._correct_points)
        solve, correct = self._orig

        def hooked_solve(prob, n_iters=20):
            out = solve(prob, n_iters=n_iters)
            self._solve = ({k: _numpy(getattr(prob, k)) for k in PROBLEM_FIELDS}, n_iters,
                           _numpy(out))
            return out

        def hooked_correct(lc, old_poses):
            st = lc.store
            with st.lock:
                pts = np.nonzero(st.pt_valid)[0]
                state = (st.kf_pose.copy(), st.kf_valid.copy(), pts, st.pt_ref_kf[pts].copy(),
                         st.pt_pos[pts].copy())
            correct(lc, old_poses)
            with st.lock:
                after = st.pt_pos[pts].copy()
            if self._solve is not None:
                problem, n_iters, solved = self._solve
                self.closures.append(Closure(problem, n_iters, solved, np.array(old_poses),
                                             *state, after))
                self._solve = None

        loop_closer.optimize_pose_graph = hooked_solve
        loop_closer.LoopCloser._correct_points = hooked_correct

    def remove(self):
        from spslam_tpu_torch.loop import loop_closer

        if self._orig is not None:
            loop_closer.optimize_pose_graph, loop_closer.LoopCloser._correct_points = self._orig
            self._orig = None


def _share(a: np.ndarray, b: np.ndarray, start: np.ndarray, valid: np.ndarray) -> tuple:
    """(largest camera-centre distance between a and b, largest move of a
    from start), over the valid slots, in metres."""
    C0, Ca, Cb = (camera_centers(T[valid].astype(np.float64)) for T in (start, a, b))
    return (float(np.linalg.norm(Ca - Cb, axis=1).max()),
            float(np.linalg.norm(Ca - C0, axis=1).max()))


def gaps(c: Closure, device, precision: str = "float32") -> dict:
    """The program's closure `c` against the reference on `device`, the
    reference in `precision`: step_gap, pose_gap and point_gap (shares of
    the move), with each in mm and the moves in mm beside them."""
    from spslam_tpu_torch.solver.pose_graph import PoseGraphProblem, optimize_pose_graph

    def d(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    p = {k: d(v) for k, v in c.problem.items()}
    start, valid = c.problem["poses"], c.problem["valid"]
    step = optimize_pose_graph(PoseGraphProblem(**p), n_iters=1).cpu().numpy()
    step_ref = ref.solve(**p, n_iters=1, precision=precision).cpu().numpy()
    solved_ref = ref.solve(**p, n_iters=c.n_iters, precision=precision).cpu().numpy()
    step_m, step_moved = _share(step, step_ref, start, valid)
    pose_m, moved = _share(c.solved, solved_ref, start, valid)
    pts = ref.correct_points(d(c.before), d(c.ref_kf), d(c.kf_valid), d(c.old_poses),
                             d(c.kf_pose)).cpu().numpy()
    pt_moved = float(np.linalg.norm(c.after - c.before, axis=1).max()) if len(pts) else 0.0
    pt_m = float(np.linalg.norm(c.after - pts, axis=1).max()) if len(pts) else 0.0
    return {"step_gap": step_m / max(step_moved, 1e-12), "pose_gap": pose_m / max(moved, 1e-12),
            "point_gap": pt_m / max(pt_moved, 1e-12), "step_gap_mm": step_m * 1e3,
            "pose_gap_mm": pose_m * 1e3, "point_gap_mm": pt_m * 1e3,
            "correction_mm": moved * 1e3, "point_correction_mm": pt_moved * 1e3,
            "keyframes": int(valid.sum()), "edges": int(c.problem["edge_valid"].sum()),
            "points": int(len(pts))}


def within(g: dict) -> bool:
    """Each gap inside its tolerance."""
    return (g["step_gap"] <= STEP_TOL and g["pose_gap"] <= SOLVE_TOL
            and g["point_gap"] <= POINT_TOL)
