"""Whole-System runs of spslam_tpu and the port on the CPU (the port also
on the card with `--device cuda`), for the reference numbers PERF.md
records (not a test: tier-1 runs tests/test_torch_system_planes.py and
tests/test_torch_lowtex.py).

    python -m tests.torch_cpu_runs lowtex [--feed u8|float] [--threads N] [--which jax,port]
    python -m tests.torch_cpu_runs planes15
    python -m tests.torch_cpu_runs loop64 [--feed u8|float] [--threads N] [--which jax,port]
                                          [--gba-inline] [--device cpu|cuda] [--repeat N]
                                          [--out PREFIX] [--step-check] [--frames N]
    python -m tests.torch_cpu_runs compare A.npz B.npz ...
    python -m tests.torch_cpu_runs resolve PREFIX_port_cuda_0_ba_worst.npz [--threads N]

lowtex: the planes lane's 30 frames (seed 7, 0.8% depth noise, local BA,
pipeline depth 2, th_depth 3.2 as tests/integration/test_slam_lowtexture.py),
each package with planes on and off.  `--feed u8` feeds u8 gray and u16
depth as chip_smoke.py does, `float` the float gray and meters of the
integration test.  planes15: the 15-frame orbit with planes
(tests/integration/test_slam_planes.py), u8 feed.  Prints one JSON line
per System: package, planes on/off, ATE, LOST frames, keyframes, map
planes; loop64 adds each closure (keyframe, the frame it was made from,
candidate, inliers, early).  `--out PREFIX` saves
each run's poses and keyframe frames to PREFIX_<package>_<device>_<i>.npz,
for comparing runs frame by frame with `python -m tests.torch_cpu_runs
compare A.npz B.npz ...` (tracked poses before any loop correction, and
final ones).  `--device cuda` runs the port on the card (the JAX package
stays on the CPU); `--step-check` then also runs every fused tracking step
on the CPU from the card's own inputs and reports how far the two poses
lie apart, and the same for every local and global bundle adjustment:
that tells a step that computes something else on the card from a
trajectory that chaos took elsewhere.  With `--out` it saves the bundle
adjustment whose point gap was largest; `resolve` solves it again here.  `--frames N` cuts the
sequence.
"""

import argparse
import dataclasses
import json
import time

import numpy as np
import torch


def _system(pkg, intr, use_planes, lowtex, use_loop=False, device="cpu"):
    if pkg == "jax":
        from spslam_tpu.geometry.camera import Intrinsics
        from spslam_tpu.system import System, SystemConfig
        from spslam_tpu.tracking.tracker import TrackerConfig
        intr = Intrinsics(*intr)
        dev = {}
    else:
        from spslam_tpu_torch.system import System, SystemConfig
        from spslam_tpu_torch.tracking.tracker import TrackerConfig
        dev = dict(device=device)
    tracker = TrackerConfig(th_depth=3.2, pipeline_depth=2) if lowtex else TrackerConfig()
    return System(SystemConfig(intr=intr, local_ba=True, use_planes=use_planes,
                               use_loop=use_loop, enable_reloc=use_loop, tracker=tracker),
                  **dev)


def compare(files):
    """Print, for each run after the first, where it parts from the first:
    the first frame made a keyframe by one run only, and the gap between
    the camera centres as tracked (before any loop correction) and as
    finally corrected, over the frames before that frame and over all
    frames; then per run its ATE, the frames farthest from the truth and
    the worst frame-to-frame motion as tracked."""
    from spslam_tpu_torch.eval.ate import ate_rmse, camera_centers
    from spslam_tpu_torch.io.synthetic import loop_trajectory

    runs = [np.load(f) for f in files]
    gt = loop_trajectory(len(runs[0]["poses"]))
    a = runs[0]
    for f, b in zip(files[1:], runs[1:]):
        ka, kb = list(a["kf_frame_id"]), list(b["kf_frame_id"])
        n = min(len(ka), len(kb))
        split = next((k for k in range(n) if ka[k] != kb[k]), n)
        first_diff = int(min(ka[split], kb[split])) if split < n else len(gt)
        out = dict(a=files[0], b=f, keyframes=(len(ka), len(kb)),
                   first_keyframe_difference=dict(kf=split, frame=first_diff))
        for key in ("tracked", "poses"):
            if key not in a or key not in b:
                continue
            gap = np.linalg.norm(camera_centers(a[key]) - camera_centers(b[key]), axis=-1)
            out[f"{key}_gap_mm_before"] = round(float(gap[:first_diff].max(initial=0)) * 1e3, 3)
            out[f"{key}_gap_mm_all"] = round(float(gap.max()) * 1e3, 3)
            over = np.nonzero(gap > 5e-3)[0]
            out[f"{key}_gap_over_5mm_from_frame"] = int(over[0]) if len(over) else None
        for name, r in (("a", a), ("b", b)):
            key = "tracked" if "tracked" in r else "poses"
            final, err = ate_rmse(r["poses"], gt)
            out[f"ate_mm_{name}"] = dict(
                before=round(ate_rmse(r[key][:first_diff], gt[:first_diff])[0] * 1e3, 3),
                final=round(final * 1e3, 3),
                without_worst_frame=round(float(np.sqrt(np.mean(np.sort(err)[:-1] ** 2))) * 1e3, 3))
            if "tracked" in r:
                # the worst frame-to-frame motion as tracked, against the
                # truth's (no alignment: a tracking glitch, not drift)
                c, cg = camera_centers(r["tracked"]), camera_centers(gt)
                step = np.linalg.norm(np.diff(c, axis=0) - np.diff(cg, axis=0), axis=-1)
                out[f"worst_tracked_step_{name}"] = (int(step.argmax()) + 1,
                                                     round(float(step.max()) * 1e3, 1))
            # the three frames farthest from the truth in the final poses:
            # (frame, final error mm, tracked error mm, tracking inliers, ref keyframe)
            if "tracked" in r:
                terr = ate_rmse(r["tracked"], gt)[1]
            out[f"worst_{name}"] = [
                (int(f_), round(float(err[f_]) * 1e3, 1),
                 round(float(terr[f_]) * 1e3, 1) if "tracked" in r else None,
                 int(r["inliers"][f_]) if "inliers" in r else None,
                 int(r["ref"][f_]) if "ref" in r else None)
                for f_ in np.argsort(-err)[:3]]
        print(json.dumps(out), flush=True)


def _step_summary(rows):
    """Median and largest gaps of a step check, with the worst frames."""
    r = np.array(rows, np.float64)
    worst = np.argsort(-r[:, 1])[:3]
    return dict(
        steps=len(r), median_gap_mm=round(float(np.median(r[:, 1])), 4),
        median_rot_deg=round(float(np.median(r[:, 2])), 5),
        median_match_equal=round(float(np.median(r[:, 5])), 4),
        # (frame, gap mm, rotation deg, inliers here, inliers on the CPU)
        worst=[(int(r[k, 0]), round(float(r[k, 1]), 3), round(float(r[k, 2]), 4),
                int(r[k, 3]), int(r[k, 4])) for k in worst])


def _step_check(tracker_mod, system, rows):
    """Wrap the port's fused tracking step so that every call is also run
    on the CPU from the same inputs (copied off the device): appends
    (frame, camera-centre gap mm, rotation gap deg, inliers here, inliers
    on the CPU, share of equal match entries) per call.  Returns what
    undoes the wrap.  The System goes on with the device's result."""
    from spslam_tpu_torch.geometry import np_lie

    orig = tracker_mod.track_frame_step

    def to_cpu(a):
        return a.cpu() if isinstance(a, torch.Tensor) else a

    def scal(out_small):
        return out_small[:12].cpu().view(torch.float32).double().numpy()

    def wrapped(*args, **kw):
        out = orig(*args, **kw)
        ref = orig(*map(to_cpu, args), **{k: to_cpu(v) for k, v in kw.items()})
        a, b = scal(out[1]), scal(ref[1])
        gap = np.linalg.norm(np_lie.camera_center(a[:7]) - np_lie.camera_center(b[:7]))
        ang = 2.0 * np.degrees(np.arccos(min(1.0, abs(float(np.dot(a[:4], b[:4]))))))
        same = float(np.mean(out[1][12:].cpu().numpy() == ref[1][12:].numpy()))
        rows.append((system.tracker.frame_id, gap * 1e3, ang, a[8], b[8], same))
        return out

    tracker_mod.track_frame_step = wrapped
    return lambda: setattr(tracker_mod, "track_frame_step", orig)


def _ba_check(module, label, rows, worst):
    """The same for the bundle_adjust that `module` calls (local BA in the
    mapper, the Newton stage of the global BA): appends (label, largest
    camera-centre gap mm over the free poses, median, 99th-percentile and
    largest point gap mm over the valid points, share of equal inlier
    flags, the farthest point's valid observations and how many of them
    carry depth) per call.  `worst` keeps the problem and both results of
    the call with the largest point gap."""
    from spslam_tpu_torch.geometry import np_lie

    orig = module.bundle_adjust

    def wrapped(prob, intr, **kw):
        out = orig(prob, intr, **kw)
        ref = orig(type(prob)(*(t.cpu() for t in prob)), intr, **kw)
        free = (prob.pose_valid & ~prob.pose_fixed).cpu().numpy()
        pv = prob.point_valid.cpu().numpy()
        a, b = out.poses.cpu().numpy()[free], ref.poses.numpy()[free]
        gap = np.linalg.norm(np_lie.camera_center(a) - np_lie.camera_center(b), axis=-1)
        pgap = np.linalg.norm(out.points.cpu().numpy()[pv] - ref.points.numpy()[pv], axis=-1)
        same = float(np.mean(out.obs_inlier.cpu().numpy() == ref.obs_inlier.numpy()))
        p_far = int(np.nonzero(pv)[0][pgap.argmax()]) if len(pgap) else -1
        obs = (prob.obs_valid & (prob.obs_pt == p_far)).cpu().numpy()
        n_depth = int((prob.obs_ur.cpu().numpy()[obs] >= 0).sum())
        rows.append((label, float(gap.max(initial=0)) * 1e3, float(np.median(pgap)) * 1e3,
                     float(np.percentile(pgap, 99)) * 1e3, float(pgap.max(initial=0)) * 1e3,
                     same, int(obs.sum()), n_depth))
        if len(pgap) and pgap.max() * 1e3 > worst.get("gap_mm", -1.0):
            worst.update(gap_mm=float(pgap.max()) * 1e3, point=p_far, label=label,
                         intr=np.array(intr, np.float64), **kw,
                         card_points=out.points.cpu().numpy(), cpu_points=ref.points.numpy(),
                         card_poses=out.poses.cpu().numpy(), cpu_poses=ref.poses.numpy(),
                         **{f"prob_{k}": v.cpu().numpy() for k, v in prob._asdict().items()})
        return out

    module.bundle_adjust = wrapped
    return lambda: setattr(module, "bundle_adjust", orig)


def _ba_summary(rows):
    out = {}
    for label in sorted({r[0] for r in rows}):
        r = np.array([x[1:] for x in rows if x[0] == label], np.float64)
        k = int(r[:, 3].argmax())
        out[label] = dict(calls=len(r), max_pose_gap_mm=round(float(r[:, 0].max()), 4),
                          median_pose_gap_mm=round(float(np.median(r[:, 0])), 4),
                          median_point_gap_mm=round(float(np.median(r[:, 1])), 4),
                          max_p99_point_gap_mm=round(float(r[:, 2].max()), 4),
                          max_point_gap_mm=round(float(r[:, 3].max()), 4),
                          # the farthest point: its valid observations, those with depth
                          max_point_obs=(int(r[k, 5]), int(r[k, 6])),
                          min_inlier_equal=round(float(r[:, 4].min()), 4))
    return out


def resolve(files, threads):
    """Solve each saved worst BA problem again here, at `threads` torch
    threads, and print how far its farthest point lands from the card's
    and the first CPU's solutions, with the point's observations and the
    widest angle between its observation rays."""
    from spslam_tpu_torch.geometry import np_lie
    from spslam_tpu_torch.geometry.camera import Intrinsics
    from spslam_tpu_torch.solver.ba import BAProblem, bundle_adjust

    torch.set_num_threads(threads)
    for f in files:
        w = np.load(f)
        prob = BAProblem(**{k: torch.from_numpy(w["prob_" + k]) for k in BAProblem._fields})
        kw = {k: int(w[k]) for k in ("stage1_iters", "stage2_iters") if k in w}
        intr = Intrinsics(*[int(v) if f in ("width", "height") else float(v)
                            for f, v in zip(Intrinsics._fields, w["intr"])])
        res = bundle_adjust(prob, intr, **kw)
        p = int(w["point"])
        here = res.points.numpy()[p]
        obs = w["prob_obs_valid"] & (w["prob_obs_pt"] == p)
        cams = w["card_poses"][w["prob_obs_cam"][obs]]
        rays = here[None] - np_lie.camera_center(cams)
        rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
        widest = float(np.degrees(np.arccos(np.clip(rays @ rays.T, -1.0, 1.0))).max())
        print(json.dumps(dict(
            file=f, label=str(w["label"]), threads=threads, point=p,
            card_vs_cpu_mm=round(float(w["gap_mm"]), 3),
            here_vs_card_mm=round(float(np.linalg.norm(here - w["card_points"][p])) * 1e3, 3),
            here_vs_cpu_mm=round(float(np.linalg.norm(here - w["cpu_points"][p])) * 1e3, 3),
            obs=int(obs.sum()), obs_with_depth=int((w["prob_obs_ur"][obs] >= 0).sum()),
            widest_ray_angle_deg=round(widest, 4),
            distance_m=round(float(np.linalg.norm(here - np_lie.camera_center(cams[0]))), 3),
        )), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("run", choices=("lowtex", "planes15", "loop64", "compare", "resolve"))
    ap.add_argument("files", nargs="*",
                    help="compare: two or more --out files; resolve: *_ba_worst.npz files")
    ap.add_argument("--feed", choices=("u8", "float"), default="u8")
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--which", default="jax,port")
    ap.add_argument("--gba-inline", action="store_true")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--step-check", action="store_true")
    ap.add_argument("--frames", type=int, default=None)
    args = ap.parse_args()
    if args.run == "compare":
        return compare(args.files)
    if args.run == "resolve":
        return resolve(args.files, args.threads)
    torch.set_num_threads(args.threads)
    from spslam_tpu_torch.eval.ate import ate_rmse
    from spslam_tpu_torch.io.synthetic import make_sequence

    lowtex = args.run == "lowtex"
    loop = args.run == "loop64"
    if lowtex:
        seq = make_sequence(n_frames=30, low_texture=True, depth_noise=0.008, seed=7)
    elif loop:
        seq = make_sequence(n_frames=64, trajectory="loop", depth_noise=0.004)
    else:
        seq = make_sequence(n_frames=15)
    frames = seq.frames[: args.frames]
    if args.feed == "u8":
        frames = [(np.clip(g, 0, 255).astype(np.uint8),
                   np.clip(d * 5000.0, 0, 65535).astype(np.uint16)) for g, d in frames]
    runs = [(pkg, use_planes, i) for pkg in args.which.split(",")
            for use_planes in ((True, False) if lowtex else (not loop,))
            for i in range(args.repeat)]
    for pkg, use_planes, i in runs:
        device = args.device if pkg == "port" else "cpu"
        t0 = time.perf_counter()
        s = _system(pkg, seq.intr, use_planes, lowtex, use_loop=loop, device=device)
        if args.gba_inline and s.loop_closer is not None:
            s.loop_closer.cfg = dataclasses.replace(s.loop_closer.cfg, gba_async=False)
        steps, bas, worst, unwraps = [], [], {}, []
        if args.step_check and pkg == "port":
            from spslam_tpu_torch.mapping import local_mapper
            from spslam_tpu_torch.solver import global_ba
            from spslam_tpu_torch.tracking import tracker as tracker_mod
            unwraps = [_step_check(tracker_mod, s, steps),
                       _ba_check(local_mapper, "local_ba", bas, worst),
                       _ba_check(global_ba, "global_ba", bas, worst)]
        calls = []
        for (gray, depth), ts in zip(frames, seq.timestamps):
            t1 = time.perf_counter()
            s.track_rgbd(gray, depth, ts)
            calls.append(time.perf_counter() - t1)
        s.shutdown()
        for unwrap in unwraps:
            unwrap()
        poses = s.poses()
        ate = ate_rmse(poses, seq.poses_gt[: len(frames)])[0]
        st = s.store
        kf_frames = st.kf_frame_id[: st.n_kf].copy()
        closed = [
            (e["kf"], int(kf_frames[e["kf"]]), e["cand"], e.get("inliers"), e["early"])
            for e in (s.loop_closer.events if s.loop_closer else []) if e["kind"] == "closed"
        ]
        if args.out:
            if worst:
                np.savez(f"{args.out}_{pkg}_{device}_{i}_ba_worst.npz", **worst)
            np.savez(f"{args.out}_{pkg}_{device}_{i}.npz", poses=poses,
                     tracked=np.stack([T for _, T in s.trajectory]),
                     ref=np.array([ref for _, ref, _ in s._rel_trajectory]),
                     inliers=np.array([m.get("inliers", -1) for m in s.tracker.metrics]),
                     state=np.array([m["state"] for m in s.tracker.metrics]),
                     step_check=np.array(steps, np.float64).reshape(-1, 6),
                     kf_frame_id=kf_frames, kf_valid=st.kf_valid[: st.n_kf])
        print(json.dumps(dict(
            run=args.run, package=pkg, device=device, planes=use_planes, feed=args.feed,
            threads=args.threads, ate_mm=round(float(ate) * 1e3, 3), closed=closed,
            lost=sum(1 for m in s.tracker.metrics if m["state"] == "LOST"),
            keyframes=int(s.store.n_kf), map_planes=int(s.store.pl_valid.sum()),
            closures=s.loop_closer.n_loops_closed if s.loop_closer else 0,
            gba_inline=args.gba_inline,
            step_check=_step_summary(steps) if steps else None,
            ba_check=_ba_summary(bas) if bas else None,
            max_call_s=round(max(calls), 2),
            seconds=round(time.perf_counter() - t0, 1))), flush=True)


if __name__ == "__main__":
    main()
