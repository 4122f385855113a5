"""Parity of the port's plane modules against spslam_tpu on the CPU:
geometry/plane, ops/plane_seg, the joint pose optimization, the plane
terms of bundle_adjust, the plane mapper and the planes branch of the
fused tracking step.

Tolerances:
* plane geometry: 1e-6 (float32 transcendentals), the azimuth wrap exact;
* segment_planes: equal `valid` and `n_inliers` (pixel counts are exact
  integer sums), coefficients within the gate the reference holds its TPU
  run to (normal dot > 0.9999994, |dd| < 2e-3), block labels equal on
  >= 99% of the blocks (a block on an eigenvalue gate boundary may flip).
  On the orbit frame 2 the gate holds as it stands.  A small grazing
  segment's float32 refit (E[xx] - mu mu^T over ~10 m^2 terms) is off an
  exact float64 refit of the same pixels by up to ~3e-2 m in d in either
  package, so each plane's gate is widened by the reference's own distance
  from that exact refit;
* plane residuals / Jacobians and pose_optimization_joint: 1e-5;
* bundle_adjust with live plane rows: poses and planes 1e-4, plane
  inlier classification equal; BA plane Jacobians against jax.jacfwd to
  1e-5 of their scale on random planes, 1e-3 a few degrees from the
  chart's pole; at the exact pole the same accept / reject decision and
  no NaN written back;
* plane mapper: same association decisions and edges, coefficients 1e-5
  on a shared segmentation;
* track_frame_step with planes: pose 1e-4, buffers as in
  tests/test_torch_tracking.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spslam_tpu.geometry import lie as jlie
from spslam_tpu.geometry import plane as jplane
from spslam_tpu.geometry.camera import Intrinsics as JIntr
from spslam_tpu.map import store as jstore
from spslam_tpu.mapping import plane_mapper as jpm
from spslam_tpu.ops import plane_seg as jps
from spslam_tpu.solver import ba as jba
from spslam_tpu.solver import pose_opt as jpo
from spslam_tpu.tracking import tracker as jtr
from spslam_tpu_torch.geometry import np_lie
from spslam_tpu_torch.geometry import plane as tplane
from spslam_tpu_torch.geometry.camera import Intrinsics as TIntr
from spslam_tpu_torch.io import synthetic as tsyn
from spslam_tpu_torch.map import store as tstore
from spslam_tpu_torch.mapping import plane_mapper as tpm
from spslam_tpu_torch.ops import plane_seg as tps
from spslam_tpu_torch.solver import ba as tba
from spslam_tpu_torch.solver import pose_opt as tpo
from spslam_tpu_torch.tracking import tracker as ttr
from tests.test_torch_common import DEV, n, t
from tests.test_torch_mapping import _ba_problem

JINTR = JIntr(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0, width=640, height=480)
TINTR = TIntr(*JINTR)


def _rand_planes(rng, k):
    nrm = rng.normal(size=(k, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return np.concatenate([nrm, rng.uniform(-4, 4, (k, 1))], 1).astype(np.float32)


def _room_planes(seed=0, low_texture=False):
    out = []
    for r in tsyn.make_room(seed, low_texture=low_texture):
        nrm = r.normal
        out.append(np.concatenate([nrm, [-np.dot(nrm, r.origin)]]))
    return np.asarray(out, np.float32)


# --- geometry ---------------------------------------------------------------

def test_plane_geometry_functions():
    rng = np.random.default_rng(0)
    pi = _rand_planes(rng, 64)
    pi2 = _rand_planes(rng, 64)
    raw = pi * rng.uniform(0.5, 2.0, (64, 1)).astype(np.float32)
    T = np.stack([np.asarray(jlie.se3_exp(jnp.asarray(x)))
                  for x in rng.normal(0, 0.5, (64, 6)).astype(np.float32)])
    x = rng.normal(size=(64, 3)).astype(np.float32)
    delta = rng.normal(0, 0.1, (64, 3)).astype(np.float32)
    tau = np.stack([rng.uniform(-3, 3, 64), rng.uniform(-1.5, 1.5, 64),
                    rng.uniform(-4, 4, 64)], 1).astype(np.float32)
    cases = [
        ("normalize_plane", (raw,)), ("plane_point_distance", (pi, x)),
        ("transform_plane", (T, pi)), ("plane_to_azel", (pi,)), ("azel_to_plane", (tau,)),
        ("plane_retract", (pi, delta)), ("plane_error", (pi, pi2)),
        ("angle_between_normals", (pi[:, :3], pi2[:, :3])),
    ]
    for name, args in cases:
        want = n(getattr(jplane, name)(*[jnp.asarray(a) for a in args]))
        got = n(getattr(tplane, name)(*[t(a) for a in args]))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(tplane.normalize_plane_np(raw),
                               n(jplane.normalize_plane(jnp.asarray(raw))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tplane.transform_plane_np(T, pi),
                               n(jplane.transform_plane(jnp.asarray(T), jnp.asarray(pi))),
                               rtol=0, atol=1e-6)


def test_plane_error_azimuth_wrap():
    # azimuths on both sides of +-pi: the raw difference is ~2 pi, the
    # wrapped one small, and -pi maps to -pi in both
    az_o = np.array([3.1, -3.1, 0.5, -math.pi, 2.0], np.float32)
    az_p = np.array([-3.1, 3.1, 0.5, 0.0, -2.0], np.float32)
    el = np.array([0.2, -0.3, 0.1, 0.0, 0.4], np.float32)
    obs = np.stack([np.cos(el) * np.cos(az_o), np.cos(el) * np.sin(az_o), np.sin(el),
                    np.ones(5)], 1).astype(np.float32)
    pred = np.stack([np.cos(el) * np.cos(az_p), np.cos(el) * np.sin(az_p), np.sin(el),
                     np.ones(5)], 1).astype(np.float32)
    want = n(jplane.plane_error(jnp.asarray(obs), jnp.asarray(pred)))
    got = n(tplane.plane_error(t(obs), t(pred)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.all(np.abs(got[:, 0]) <= math.pi + 1e-6) and abs(got[0, 0]) < 0.1


# --- segmentation -------------------------------------------------------------

def _seg_scene(name):
    """(depth [H,W] float32, intrinsics) of the five scenes of
    tests/unit/test_plane_seg.py and a rendered orbit frame at 640x480 and
    at the tracker's 320x240 stride-2 depth."""
    H, W = 480, 640
    if name == "single":
        return np.full((H, W), 3.0, np.float32), JINTR
    if name == "sloped":
        _, xs = np.mgrid[0:H, 0:W]
        a = 0.3 * (xs - JINTR.cx) / JINTR.fx
        return (2.0 / np.maximum(1 - a, 0.3)).astype(np.float32), JINTR
    if name == "two":
        d = np.full((H, W), 2.0, np.float32)
        d[:, 320:] = 4.0
        return d, JINTR
    if name == "noise":
        return np.random.default_rng(0).uniform(0.5, 6.0, (H, W)).astype(np.float32), JINTR
    if name == "room":
        T = tsyn.orbit_trajectory(3)[0]
        return tsyn.render_frame(tsyn.make_room(seed=0), T, TINTR)[1], JINTR
    T = tsyn.orbit_trajectory(3)[2]
    depth = tsyn.render_frame(tsyn.make_room(seed=0), T, TINTR)[1]
    if name == "frame2_full":
        return depth, JINTR
    s = 2
    intr = JINTR._replace(fx=JINTR.fx / s, fy=JINTR.fy / s, cx=JINTR.cx / s, cy=JINTR.cy / s,
                          width=W // s, height=H // s)
    return np.ascontiguousarray(depth[::s, ::s]), intr


def _exact_refit(depth, intr, block_label, k, block=8):
    """float64 least-squares plane of the valid pixels of the blocks
    labelled k, oriented toward the camera."""
    mask = np.kron(block_label == k, np.ones((block, block), bool))
    z = depth[: mask.shape[0], : mask.shape[1]].astype(np.float64)
    ys, xs = np.mgrid[0: mask.shape[0], 0: mask.shape[1]]
    sel = mask & (z > 1e-3) & (z < 8.0)
    p = np.stack([(xs[sel] - intr.cx) / intr.fx * z[sel], (ys[sel] - intr.cy) / intr.fy * z[sel],
                  z[sel]], -1)
    mu = p.mean(0)
    nrm = np.linalg.eigh(np.cov((p - mu).T, bias=True))[1][:, 0]
    nrm = -nrm if np.dot(nrm, mu) > 0 else nrm
    return np.concatenate([nrm, [-np.dot(nrm, mu)]])


def _angle(a, b):
    return float(np.arccos(np.clip(abs(np.dot(a[:3], b[:3])), -1.0, 1.0)))


GATE_ANGLE = math.acos(0.9999994)   # ~1.1e-3 rad


@pytest.mark.parametrize("scene", ["single", "sloped", "two", "noise", "room",
                                   "frame2_full", "frame2_half"])
def test_segment_planes_matches_reference(scene):
    depth, intr = _seg_scene(scene)
    jr = jps.segment_planes(jnp.asarray(depth), intr)
    tr = tps.segment_planes(t(depth), TIntr(*intr))
    vj, vt = n(jr.valid), n(tr.valid)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(n(tr.n_inliers), n(jr.n_inliers))
    jlab = n(jr.block_label)
    for k in np.nonzero(vt)[0]:
        a, b = n(tr.coef)[k], n(jr.coef)[k]
        b = -b if np.dot(a[:3], b[:3]) < 0 else b
        if scene.startswith("frame2"):         # the reference's own parity scene
            assert np.dot(a[:3], b[:3]) > 0.9999994, (a, b)
            assert abs(a[3] - b[3]) < 2e-3, (a, b)
        ex = _exact_refit(depth, intr, jlab, k)
        assert _angle(a, b) <= GATE_ANGLE + _angle(b, ex), (k, a, b, ex)
        assert abs(a[3] - b[3]) <= 2e-3 + abs(b[3] - ex[3]), (k, a, b, ex)
    assert np.mean(n(tr.block_label) == jlab) >= 0.99
    if scene in ("single", "room", "frame2_full"):
        assert vt.sum() >= 1
    if scene == "noise":
        assert vt.sum() == 0


def test_segment_planes_internals():
    """Block moments, eigen-gates and the label propagation alone."""
    depth, intr = _seg_scene("frame2_full")
    ys, xs = np.mgrid[0:480, 0:640].astype(np.float32)
    z = depth
    xyz = np.stack([(xs - intr.cx) / intr.fx * z, (ys - intr.cy) / intr.fy * z, z], -1)
    valid = (z > 1e-3) & (z < 8.0)
    jc, jm, jcov = jps._block_moments(jnp.asarray(xyz), jnp.asarray(valid), 8)
    tc, tm, tcov = tps._block_moments(t(xyz), t(valid), 8)
    np.testing.assert_array_equal(n(tc), n(jc))
    np.testing.assert_allclose(n(tm), n(jm), rtol=0, atol=1e-5)
    np.testing.assert_allclose(n(tcov), n(jcov), rtol=0, atol=1e-6)
    rng = np.random.default_rng(1)
    init = np.where(rng.uniform(size=(30, 40)) < 0.8, np.arange(1200).reshape(30, 40),
                    1 << 30).astype(np.int32)
    ok_r = rng.uniform(size=(30, 40)) < 0.7
    ok_d = rng.uniform(size=(30, 40)) < 0.7
    ok_r[:, -1] = False
    ok_d[-1, :] = False
    for iters in (1, 24):
        np.testing.assert_array_equal(
            n(tps._propagate_labels(t(init), t(ok_r), t(ok_d), iters)),
            n(jps._propagate_labels(jnp.asarray(init), jnp.asarray(ok_r), jnp.asarray(ok_d),
                                    iters)))


# --- joint pose optimization -------------------------------------------------

def _pose_scene(seed, n_pts, px_noise):
    """The scene of tests/unit/test_pose_opt_planes.py: points and three
    orthogonal world planes (one of them [0, 0, 1, -8]) seen exactly."""
    rng = np.random.default_rng(seed)
    T_true = np.array([0.9995, 0.02, -0.015, 0.01, 0.05, -0.03, 0.08], np.float32)
    T_true[:4] /= np.linalg.norm(T_true[:4])
    pts = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                    rng.uniform(3, 7, n_pts)], -1).astype(np.float32)
    xc = np_lie.se3_apply(T_true, pts)
    uv = np.stack([525 * xc[:, 0] / xc[:, 2] + 319.5, 525 * xc[:, 1] / xc[:, 2] + 239.5], -1)
    uv = (uv + rng.normal(0, px_noise, uv.shape)).astype(np.float32)
    ur = (uv[:, 0] - 40.0 / xc[:, 2] + rng.normal(0, px_noise, n_pts)).astype(np.float32)
    pl_w = np.zeros((4, 4), np.float32)
    pl_w[:3] = [[0, 0, 1, -8.0], [1, 0, 0, 2.5], [0, 1, 0, 1.8]]
    pl_c = tplane.transform_plane_np(T_true, pl_w)
    pl_c[3] = 0.0
    return T_true, pts, uv, ur, pl_w, pl_c, np.arange(4) < 3


@pytest.mark.parametrize("case", ["weak_points", "planes_only", "sign_flipped"])
def test_pose_optimization_joint(case):
    if case == "weak_points":
        T_true, pts, uv, ur, pl_w, pl_c, plv = _pose_scene(11, 24, 2.0)
        T0 = T_true + np.array([0, 0, 0, 0, 0.04, -0.03, 0.05], np.float32)
        w, valid, info, rounds, iters = np.ones(24, np.float32), np.ones(24, bool), 1e5, 3, 8
    else:
        T_true, pts, uv, ur, pl_w, pl_c, plv = _pose_scene(12, 4, 8.0)
        T0 = T_true + np.array([0, 0, 0, 0, 0.06, -0.05, 0.04], np.float32)
        w, valid, info, rounds, iters = np.zeros(4, np.float32), np.zeros(4, bool), 1e4, 3, 10
        if case == "sign_flipped":
            pl_c = -pl_c
    args = [T0, pts, uv, ur, w, valid, pl_w, pl_c, plv, np.full(4, info, np.float32)]
    jr = jpo.pose_optimization_joint(*[jnp.asarray(a) for a in args], JINTR,
                                     n_rounds=rounds, n_iters=iters)
    tr = tpo.pose_optimization_joint(*[t(a) for a in args], TINTR, n_rounds=rounds,
                                     n_iters=iters)
    np.testing.assert_allclose(n(tr.T_cw), n(jr.T_cw), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(n(tr.inliers), n(jr.inliers))
    assert int(tr.n_inliers) == int(jr.n_inliers)
    if case != "weak_points":     # three planes pin the pose
        d = np_lie.se3_compose(n(tr.T_cw), np_lie.se3_inverse(T_true))
        assert np.linalg.norm(d[4:7]) < 1e-4
    # the residuals and Jacobians at the start
    je, jJ = jpo._plane_residuals_and_jac(*[jnp.asarray(a) for a in (T0, pl_w, pl_c, plv)])
    te, tJ = tpo._plane_residuals_and_jac(*[t(a) for a in (T0, pl_w, pl_c, plv)])
    np.testing.assert_allclose(n(te), n(je), rtol=0, atol=1e-5)
    np.testing.assert_allclose(n(tJ), n(jJ), rtol=0, atol=1e-5)


# --- bundle adjustment with plane rows --------------------------------------

def _ba_plane_problem(seed):
    """_ba_problem's point problem plus four world planes (a parallel pair,
    perpendicular ones) observed from every camera with noise, one gross
    plane outlier, and three structural edges; one padding plane row."""
    d = _ba_problem(seed)
    rng = np.random.default_rng(100 + seed)
    c, s = 0.6, 0.8
    true = np.array([[1, 0, 0, -2.0], [1, 0, 0, 3.0], [0, c, s, -4.0], [0, s, -c, 1.0]],
                    np.float32)
    L, Q, E = 5, 32, 4
    planes = np.tile(np.array([0, 0, 1, 0], np.float32), (L, 1))
    for i, p in enumerate(true):
        tau = n(jplane.plane_to_azel(jnp.asarray(p))) + rng.normal(0, 0.02, 3)
        planes[i] = n(jplane.azel_to_plane(jnp.asarray(tau.astype(np.float32))))
    n_cams = int(d["pose_valid"].sum())
    poses_true = [n(jlie.se3_exp(jnp.asarray(np.array(
        [0.3 * i, 0.02 * i, 0.01 * i, 0.0, 0.05 * i, 0.0], np.float32)))) for i in range(n_cams)]
    pobs = dict(pobs_cam=np.zeros(Q, np.int32), pobs_plane=np.zeros(Q, np.int32),
                pobs_pi=np.tile(np.array([0, 0, 1, 0], np.float32), (Q, 1)),
                pobs_w=np.zeros(Q, np.float32), pobs_valid=np.zeros(Q, bool))
    q = 0
    for cam in range(n_cams):
        for li in range(4):
            pc = tplane.transform_plane_np(poses_true[cam], true[li])
            pobs["pobs_cam"][q], pobs["pobs_plane"][q] = cam, li
            pobs["pobs_pi"][q] = pc + rng.normal(0, 0.003, 4).astype(np.float32)
            pobs["pobs_w"][q] = rng.uniform(1.0, 20.0)
            pobs["pobs_valid"][q] = True
            q += 1
    pobs["pobs_pi"][q - 1, 3] += 1.0                      # a gross outlier
    pobs["pobs_w"][q - 1] = 20.0
    d.update(planes=planes, plane_valid=np.arange(L) < 4, **pobs,
             pp_a=np.array([0, 0, 2, 0], np.int32), pp_b=np.array([1, 2, 3, 0], np.int32),
             pp_type=np.array([0, 1, 1, 0], np.int32),
             pp_w=np.array([10, 10, 10, 0], np.float32), pp_valid=np.arange(E) < 3)
    return d


def _ba_both(d, s1, s2):
    tres = tba.bundle_adjust(tba.BAProblem(**{k: t(v) for k, v in d.items()}), TINTR, s1, s2)
    jres = jba.bundle_adjust(jba.BAProblem(**{k: jnp.asarray(v) for k, v in d.items()}),
                             JINTR, stage1_iters=s1, stage2_iters=s2)
    return tres, jres


@pytest.mark.parametrize("seed", [0, 1])
def test_bundle_adjust_with_planes(seed):
    d = _ba_plane_problem(seed)
    tres, jres = _ba_both(d, 4, 6)
    np.testing.assert_allclose(n(tres.poses), n(jres.poses), rtol=0, atol=1e-4)
    np.testing.assert_allclose(n(tres.planes), n(jres.planes), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(n(tres.pobs_inlier), n(jres.pobs_inlier))
    np.testing.assert_array_equal(n(tres.obs_inlier), n(jres.obs_inlier))
    inl = n(tres.pobs_inlier)
    assert not inl[23] and inl[:23].all()      # the outlier is gated out, the rest stay
    # the planes moved toward the truth
    true_d = np.array([-2.0, 3.0, -4.0, 1.0])
    assert np.abs(n(tres.planes)[:4, 3] - true_d).max() < np.abs(d["planes"][:4, 3] - true_d).max()


def _jac_case(normals, seed):
    rng = np.random.default_rng(seed)
    k = len(normals)
    planes = np.concatenate([normals, rng.uniform(-3, 3, (k, 1))], 1).astype(np.float32)
    poses = np.stack([n(jlie.se3_exp(jnp.asarray(x)))
                      for x in rng.normal(0, 0.2, (4, 6)).astype(np.float32)])
    Q = 16
    cam = rng.integers(0, 4, Q).astype(np.int32)
    pl = rng.integers(0, k, Q).astype(np.int32)
    obs = np.stack([tplane.transform_plane_np(poses[c], planes[p]) for c, p in zip(cam, pl)])
    fields = dict(pobs_cam=cam, pobs_plane=pl,
                  pobs_pi=(obs + rng.normal(0, 0.01, obs.shape)).astype(np.float32),
                  pobs_w=np.full(Q, 10.0, np.float32), pobs_valid=np.ones(Q, bool),
                  pp_a=rng.integers(0, k, 6).astype(np.int32),
                  pp_b=rng.integers(0, k, 6).astype(np.int32),
                  pp_type=(np.arange(6) % 2).astype(np.int32),
                  pp_w=np.full(6, 10.0, np.float32), pp_valid=np.ones(6, bool))
    d = _ba_problem(0)
    d.update(fields)
    return poses, planes, d


@pytest.mark.parametrize("where", ["random", "near_vertical"])
def test_ba_plane_jacobians_against_jacfwd(where):
    rng = np.random.default_rng(7)
    if where == "random":
        nrm = rng.normal(size=(6, 3))
        tol = 1e-5
    else:                                        # 2-5 degrees off +-z
        ang = np.radians(rng.uniform(2, 5, 6))
        az = rng.uniform(-np.pi, np.pi, 6)
        nrm = np.stack([np.sin(ang) * np.cos(az), np.sin(ang) * np.sin(az),
                        np.cos(ang) * np.sign(rng.normal(size=6))], 1)
        tol = 1e-3
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    poses, planes, d = _jac_case(nrm, 3)
    jprob = jba.BAProblem(**{k: jnp.asarray(v) for k, v in d.items()})
    tprob = tba.BAProblem(**{k: t(v) for k, v in d.items()})
    jo = jba._plane_obs_residuals(jnp.asarray(poses), jnp.asarray(planes), jprob)
    to = tba._plane_obs_residuals(t(poses), t(planes), tprob)
    jp = jba._plane_plane_residuals(jnp.asarray(planes), jprob)
    tp = tba._plane_plane_residuals(t(planes), tprob)
    for name, a, b in [("e", jo[0], to[0]), ("J_c", jo[1], to[1]), ("J_pl", jo[2], to[2]),
                       ("pp_e", jp[0], tp[0]), ("J_a", jp[1], tp[1]), ("J_b", jp[2], tp[2])]:
        a, b = n(a), n(b)
        assert b.dtype == np.float32 and np.isfinite(b).all(), name
        scale = max(np.abs(a).max(), 1e-6)
        assert np.abs(a - b).max() <= tol * scale, (name, np.abs(a - b).max(), scale)
    np.testing.assert_allclose(n(to[3]), n(jo[3]), rtol=1e-5, atol=1e-6)


def test_ba_at_the_chart_pole_decides_alike():
    """A live plane exactly at the pole ([0, 0, 1, -8] of the pose-opt
    scene, seen from the identity pose): the retracted prediction sits
    4e-8 off the pole, so the azimuth Jacobian is ~1/4e-8 in both packages.
    Both take the same LM decision and neither writes a NaN back."""
    d = _ba_plane_problem(0)
    d["planes"][0] = [0, 0, 1, -8.0]
    d["pobs_plane"][:] = 0
    d["pobs_cam"][:] = np.arange(len(d["pobs_cam"])) % 6
    d["pobs_pi"][:] = [0, 0, 1, -8.0]
    d["pp_valid"][:] = False
    poses_j = jnp.asarray(d["poses"])
    _, jc, _, _ = jba._plane_obs_residuals(poses_j, jnp.asarray(d["planes"]),
                                           jba.BAProblem(**{k: jnp.asarray(v) for k, v in d.items()}))
    _, tc, _, _ = tba._plane_obs_residuals(t(d["poses"]), t(d["planes"]),
                                           tba.BAProblem(**{k: t(v) for k, v in d.items()}))
    assert np.abs(n(jc)).max() > 1e6 and np.abs(n(tc)).max() > 1e6
    for s1, s2 in ((1, 0), (2, 2)):
        tres, jres = _ba_both(d, s1, s2)
        for field in ("poses", "points", "planes"):
            a, b = n(getattr(tres, field)), n(getattr(jres, field))
            assert np.isfinite(a).all() and np.isfinite(b).all(), field
            moved_t = not np.array_equal(a, d[field])
            moved_j = not np.array_equal(b, d[field])
            assert moved_t == moved_j, (field, s1, s2, moved_t, moved_j)
        np.testing.assert_array_equal(n(tres.pobs_inlier), n(jres.pobs_inlier))


# --- plane mapper -------------------------------------------------------------

@pytest.mark.parametrize("segmentation", ["shared", "own"])
def test_plane_mapper_against_reference(segmentation, monkeypatch):
    """'shared': both mappers get the reference's segmentation of each
    keyframe, which isolates the mapper's own arithmetic (1e-5).  'own':
    each package segments; a small grazing segment's float32 refit differs
    by up to ~3e-3 m in d between the packages (test_segment_planes_*), so
    the coefficients are held to 5e-3 there, the decisions exactly."""
    if segmentation == "shared":
        seen = []

        def ref_seg(depth, intr):
            res = jps.segment_planes(depth, intr)
            seen.append(res)
            return res

        def port_seg(depth, intr):
            res = seen.pop(0)
            return tps.FramePlanes(*[t(np.asarray(x)) for x in res])

        monkeypatch.setattr(jpm, "segment_planes", ref_seg)
        monkeypatch.setattr(tpm, "segment_planes", port_seg)
    seq = tsyn.make_sequence(n_frames=9)
    n_kp = 16
    stores = []
    for mod in (jstore, tstore):
        st = mod.MapStore(mod.MapConfig(max_keyframes=8, max_points=64, max_planes=4,
                                        n_kp=n_kp))
        for k, fi in enumerate((0, 4, 8)):
            fr = dict(uv=np.zeros((n_kp, 2), np.float32), octave=np.zeros(n_kp, np.int32),
                      angle=np.zeros(n_kp, np.float32), desc=np.zeros((n_kp, 8), np.uint32),
                      depth=np.zeros(n_kp, np.float32),
                      u_right=np.full(n_kp, -1.0, np.float32), valid=np.zeros(n_kp, bool))
            T = np_lie.se3_compose(seq.poses_gt[fi], np_lie.se3_inverse(seq.poses_gt[0]))
            st.add_keyframe(T, float(k), fr, fi)
        stores.append(st)
    jst, tst = stores
    jm = jpm.PlaneMapper(JINTR, jst)
    tm = tpm.PlaneMapper(TINTR, tst, device=DEV)
    for k, fi in enumerate((0, 4, 8)):
        gray, depth = seq.frames[fi]
        d16 = np.clip(depth * 5000.0, 0, 65535).astype(np.uint16)
        v0 = tst.version
        ids_j = jm.process_keyframe(k, gray, d16)
        assert tm.process_keyframe(k, d16) == ids_j
        assert tst.version > v0                      # the tracker's snapshot refreshes
    assert tst.n_pl == jst.n_pl >= 5                 # grew past the initial 4 rows
    tol = 1e-5 if segmentation == "shared" else 5e-3
    np.testing.assert_allclose(tst.pl_coef, jst.pl_coef, rtol=0, atol=tol)
    np.testing.assert_allclose(tst.pl_obs_pi, jst.pl_obs_pi, rtol=0, atol=tol)
    for k in ("pl_valid", "pl_obs_kf", "pl_obs_count", "pl_ref_kf", "pl_n_pts", "pl_obs_w",
              "ppe_a", "ppe_b", "ppe_type"):
        np.testing.assert_array_equal(getattr(tst, k), getattr(jst, k), err_msg=k)
    assert tst.pl_obs_count.max() >= 2 and len(tst.ppe_a) >= 1


# --- the planes branch of the fused tracking step ----------------------------

@pytest.fixture(scope="module")
def step_scene():
    seq = tsyn.make_sequence(n_frames=3)
    frames = [(np.clip(g, 0, 255).astype(np.uint8),
               np.clip(d * 5000.0, 0, 65535).astype(np.uint16)) for g, d in seq.frames]
    cfg = jtr.TrackerConfig()
    jt = jtr.Tracker(cfg, JIntr(*seq.intr), jstore.MapStore(jstore.MapConfig()))
    jt.process(*frames[0], 0.0)
    _, pack, desc, _ = jt._local_snapshot()
    # the room's planes in the map frame (camera 0's)
    pl = tplane.transform_plane_np(seq.poses_gt[0], _room_planes())
    pl_pack = np.zeros((ttr.PLANE_CAP, 5), np.float32)
    pl_pack[: len(pl), :4] = pl
    pl_pack[: len(pl), 4] = 1.0
    gray, depth = frames[2]
    return dict(seq=seq, cfg=cfg, spec=jt.spec, pack=n(pack), desc=n(desc), pl_pack=pl_pack,
                gray=gray, depth2=np.ascontiguousarray(depth[::2, ::2]))


@pytest.mark.parametrize("prior", ["true", "offset"])
def test_track_frame_step_with_planes(step_scene, prior):
    sc = step_scene
    cfg, intr, gt = sc["cfg"], sc["seq"].intr, sc["seq"].poses_gt
    T_true = np_lie.se3_compose(gt[2], np_lie.se3_inverse(gt[0]))
    T_prev = T_true.copy()
    if prior == "offset":
        T_prev[4:7] += np.array([0.02, -0.015, 0.02], np.float32)
    _, js, jb = jtr.track_frame_step(
        jnp.asarray(sc["gray"]), jnp.asarray(sc["depth2"]), jnp.asarray(T_prev),
        jnp.asarray(T_prev), jnp.asarray(False), jnp.asarray(sc["pack"]),
        jnp.asarray(sc["desc"]), jnp.asarray(sc["pl_pack"]), cfg.motion_search_radius,
        cfg.local_search_radius, cfg.th_depth, sc["spec"], JIntr(*intr), cfg.n_features,
        cfg.th_fast_high, cfg.th_fast_low, use_planes=True,
    )
    _, ts_, tb = ttr.track_frame_step(
        t(sc["gray"]), t(sc["depth2"].view(np.int16)), t(T_prev), t(T_prev),
        torch.tensor(False), t(sc["pack"]), t(sc["desc"]), cfg.motion_search_radius,
        cfg.local_search_radius, cfg.th_depth, ttr.PyramidSpec(*sc["spec"]), intr,
        cfg.n_features, cfg.th_fast_high, cfg.th_fast_low, pl_pack=t(sc["pl_pack"]),
    )
    js, jb = np.asarray(js), np.asarray(jb)
    ts_, tb = n(ts_).view(np.uint32), n(tb).view(np.uint32)
    jscal, jmp = ttr.unpack_track_small(js, cfg.local_points_cap)
    tscal, tmp = ttr.unpack_track_small(ts_, cfg.local_points_cap)
    np.testing.assert_allclose(tscal[:7], jscal[:7], rtol=0, atol=1e-4)
    slack = int(0.01 * cfg.n_features)
    np.testing.assert_allclose(tscal[7:11], jscal[7:11], rtol=0, atol=slack)
    assert tscal[11] == jscal[11] == -1
    assert np.sum(tmp != jmp) <= slack
    jf = jtr.unpack_track_big(jb, cfg.n_features, JIntr(*intr), 5000.0)
    tf = ttr.unpack_track_big(tb, cfg.n_features, intr, 5000.0)
    for k in ("uv", "octave", "depth", "u_right", "valid", "xyz_cam"):
        np.testing.assert_array_equal(tf[k], jf[k], err_msg=k)
    assert np.linalg.norm(tscal[4:7] - T_true[4:7]) < 0.01
