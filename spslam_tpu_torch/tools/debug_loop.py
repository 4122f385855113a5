"""Trace the loop detector's gates keyframe by keyframe (port of
tools/debug_loop.py).

For each keyframe the LoopCloser processes with detection on: the weakest
covisible keyframe's BoW score (`covis_min`), the min-score gate it sets
(never below LoopConfig.min_score_floor), the five best BoW scores over
the rest of the keyframe database and the database keyframes the query
excludes; then `GEO kf cand PASS/fail` for each geometric check, the
consistent groups and whether the keyframe `closed` a loop.  The gates are
the ones the detector applied (LoopCloser._gates, kept in
LoopCloser.last_gates), not a second copy of their formula.

`GateTracer` wraps the methods of ONE LoopCloser instance and restores
them when the `with` block ends (the reference patches the class for the
whole process), so it can ride along on any System.

    python -m spslam_tpu_torch.tools.debug_loop [--device cpu]

runs it on the reference's 64-frame synchronous loop sequence (0.4% depth
noise, local BA, use_loop).
"""

from __future__ import annotations

import argparse
import sys
import time


def top_and_excluded(lc, gates) -> tuple:
    """The five best BoW scores of the keyframe the detector last ran on
    over the rest of the keyframe database, as [(kf, score)], and the
    database keyframes its query excluded."""
    from ..loop.vocab import bow_similarity

    kf, bow = gates["kf"], gates["bow"]
    with lc.kfdb._lock:
        db = {int(k): b for k, b in lc.kfdb.bow.items() if k != kf}
    top = sorted(((bow_similarity(bow, b), k) for k, b in db.items()), reverse=True)[:5]
    return [(k, v) for v, k in top], sorted(gates["exclude"] & db.keys())


class GateTracer:
    """`with GateTracer(lc, emit):` prints (through emit) and keeps in
    .rows the gates of every keyframe lc processes with detection on, as
    LoopCloser.process_keyframe applied them (lc.last_gates).  .seconds sums
    the tracer's own host time inside those calls."""

    NAMES = ("process_keyframe", "_geometric_check")

    def __init__(self, lc, emit=print):
        self.lc = lc
        self.emit = emit
        self.rows: list[dict] = []
        self.seconds = 0.0
        self._saved = {}

    def __enter__(self):
        lc = self.lc
        for name in self.NAMES:
            self._saved[name] = lc.__dict__.get(name)
        process, geo = lc.process_keyframe, lc._geometric_check
        geo_seen = []

        def traced_geo(kf, cand, *a, **k):
            ok, T = geo(kf, cand, *a, **k)
            geo_seen.append((int(kf), int(cand), bool(ok)))
            return ok, T

        def traced(kf, detect=True):
            if not detect:
                return process(kf, detect)
            geo_seen.clear()
            lc.last_gates = None
            r = process(kf, detect)
            t0 = time.perf_counter()
            g = lc.last_gates
            if g is None:
                self.emit(f"KF {kf}: vocab not trained yet -> {r}")
                self.seconds += time.perf_counter() - t0
                return r
            top, excluded = top_and_excluded(lc, g)
            fid = int(lc.store.kf_frame_id[kf])
            row = dict(kf=int(kf), frame=fid, covis_min=g["covis_min"],
                       min_score=g["min_score"], top=top, excluded=excluded,
                       geo=list(geo_seen),
                       consistent=[(sorted(grp)[:4], c) for grp, c in lc._consistent][:6],
                       closed=bool(r))
            self.rows.append(row)
            cm = row["covis_min"]
            self.emit(f"KF {kf} (frame {fid}): covis_min={cm if cm is None else round(cm, 4)} "
                      f"min_score={round(row['min_score'], 4)} "
                      f"top={[(k, round(v, 4)) for k, v in top]} excluded={excluded}")
            for k, c, ok in row["geo"]:
                self.emit(f"  GEO kf={k} cand={c} -> {'PASS' if ok else 'fail'}")
            self.emit(f"   consistent-groups: {row['consistent']} -> closed={r}")
            self.seconds += time.perf_counter() - t0
            return r

        lc.process_keyframe = traced
        lc._geometric_check = traced_geo
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            if fn is None:
                self.lc.__dict__.pop(name, None)
            else:
                setattr(self.lc, name, fn)
        return False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the loop detector's gates per keyframe")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    from .. import resolve_device
    from ..eval.ate import ate_rmse
    from ..io.synthetic import make_sequence
    from ..system import System, SystemConfig

    dev = resolve_device(args.device)
    print(f"device={dev}", file=sys.stderr)
    seq = make_sequence(n_frames=64, trajectory="loop", depth_noise=0.004)
    sys_ = System(SystemConfig(intr=seq.intr, local_ba=True, use_loop=True), device=dev)
    with GateTracer(sys_.loop_closer):
        for (gray, depth), ts in zip(seq.frames, seq.timestamps):
            sys_.track_rgbd(gray, depth, ts)
        sys_.shutdown()
    print("n_kf:", sys_.store.n_kf, "loops:", sys_.loop_closer.n_loops_closed)
    rmse, _ = ate_rmse(sys_.poses(), seq.poses_gt)
    print("ATE:", rmse)
    return 0


if __name__ == "__main__":
    sys.exit(main())
