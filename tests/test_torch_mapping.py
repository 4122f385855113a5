"""Parity of the port's solver/ba, mapping/fuse and map/store against
spslam_tpu on the CPU.

Tolerances: point-only bundle_adjust poses within 1e-4 and 99% of the
points within 2e-4 m (each float32 solver ~1e-4 m off a float64 solve),
every point within 2e-3 m; inlier classification
equal.  The normal equations are float32 sums in another order (the port
scatter-adds the camera blocks where the reference contracts one-hot
matrices; on CUDA those adds are atomics in run-dependent order) and the
reduced camera system is ill-conditioned along weakly observed point
depths: after one LM step both float32 solvers already sit ~1e-4 m from a
float64 solve of the same problem, and ten steps carry a few weakly
constrained points apart by up to ~1e-3 m.  Masked plane rows contribute exactly zero: garbage in masked plane
fields leaves the port's result bit-identical; a live plane observation
matches the reference to the same 1e-4 in the poses.  Fuse matches identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from spslam_tpu.geometry import camera as jcam
from spslam_tpu.geometry import lie as jlie
from spslam_tpu.map import store as jstore
from spslam_tpu.mapping import fuse as jfuse
from spslam_tpu.solver import ba as jba
from spslam_tpu_torch.geometry import camera as tcam
from spslam_tpu_torch.map import store as tstore
from spslam_tpu_torch.mapping import fuse as tfuse
from spslam_tpu_torch.solver import ba as tba
from tests.test_torch_common import DEV, n, t

JINTR = jcam.Intrinsics(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0, width=640, height=480)
TINTR = tcam.Intrinsics(*JINTR)


def _ba_problem(seed, M=8, n_cams=6, P=160, n_pts=128, omax=8, outlier_frac=0.05):
    """Padded point-only BA problem as a dict of numpy arrays."""
    rng = np.random.default_rng(seed)
    poses_true = np.stack([np.asarray(jlie.se3_exp(jnp.asarray(np.array(
        [0.3 * i, 0.02 * i, 0.01 * i, 0.0, 0.05 * i, 0.0], np.float32)))) for i in range(n_cams)])
    pts = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                    rng.uniform(2, 5, n_pts)], -1).astype(np.float32)
    cams, pids, uvs, urs, octs = [], [], [], [], []
    for c in range(n_cams):
        xc = np.asarray(jlie.se3_apply(jnp.asarray(poses_true[c]), jnp.asarray(pts)))
        uv = np.stack([525 * xc[:, 0] / xc[:, 2] + 319.5, 525 * xc[:, 1] / xc[:, 2] + 239.5], -1)
        vis = (uv[:, 0] > 0) & (uv[:, 0] < 640) & (uv[:, 1] > 0) & (uv[:, 1] < 480)
        for p in np.nonzero(vis)[0]:
            u = uv[p] + rng.normal(0, 0.3, 2)
            if rng.uniform() < outlier_frac:
                u = u + rng.uniform(20, 60, 2)
            cams.append(c)
            pids.append(p)
            uvs.append(u)
            # RGB-D rows (the tracker's points all have depth), a few mono
            urs.append(u[0] - 40.0 / xc[p, 2] if rng.uniform() < 0.95 else -1.0)
            octs.append(rng.integers(0, 4))
    R = 640                                # one padded shape for every problem
    k = len(cams)
    assert k < R
    pt_obs = np.full((P, omax), -1, np.int32)
    cnt = np.zeros(P, np.int32)
    for r, p in enumerate(pids):
        if cnt[p] < omax:
            pt_obs[p, cnt[p]] = r
            cnt[p] += 1
    poses = np.tile(np.array([1, 0, 0, 0, 0, 0, 0], np.float32), (M, 1))
    poses[:n_cams] = poses_true
    for c in range(1, n_cams):
        poses[c] = np.asarray(jlie.se3_retract(jnp.asarray(poses_true[c]), jnp.asarray(
            rng.normal(0, 0.02, 6).astype(np.float32))))
    points = np.zeros((P, 3), np.float32)
    points[:n_pts] = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)

    def pad(a, fill, dtype):
        out = np.full((R,) + np.asarray(a).shape[1:], fill, dtype)
        out[:k] = a
        return out

    L, Q, E = 3, 5, 2
    return dict(
        poses=poses, pose_fixed=np.arange(M) == 0, pose_valid=np.arange(M) < n_cams,
        points=points, point_valid=np.arange(P) < n_pts,
        obs_cam=pad(cams, 0, np.int32), obs_pt=pad(pids, 0, np.int32),
        obs_uv=pad(np.array(uvs), 0.0, np.float32), obs_ur=pad(urs, -1.0, np.float32),
        obs_inv_sigma2=pad(1.2 ** (-2.0 * np.array(octs)), 1.0, np.float32),
        obs_valid=np.arange(R) < k, pt_obs=pt_obs,
        planes=np.tile(np.array([0, 0, 1, 0], np.float32), (L, 1)), plane_valid=np.zeros(L, bool),
        pobs_cam=np.zeros(Q, np.int32), pobs_plane=np.zeros(Q, np.int32),
        pobs_pi=np.tile(np.array([0, 0, 1, 0], np.float32), (Q, 1)),
        pobs_w=np.zeros(Q, np.float32), pobs_valid=np.zeros(Q, bool),
        pp_a=np.zeros(E, np.int32), pp_b=np.zeros(E, np.int32), pp_type=np.zeros(E, np.int32),
        pp_w=np.zeros(E, np.float32), pp_valid=np.zeros(E, bool),
    )


def _run_both(d, s1=4, s2=6):
    tres = tba.bundle_adjust(tba.BAProblem(**{k: t(v) for k, v in d.items()}), TINTR, s1, s2)
    jres = jba.bundle_adjust(jba.BAProblem(**{k: jnp.asarray(v) for k, v in d.items()}),
                             JINTR, stage1_iters=s1, stage2_iters=s2)
    return tres, jres


@pytest.mark.parametrize("seed", [0, 1])
def test_bundle_adjust_point_only(seed):
    d = _ba_problem(seed)
    tres, jres = _run_both(d)
    np.testing.assert_allclose(n(tres.poses), n(jres.poses), rtol=0, atol=1e-4)
    dp = np.abs(n(tres.points) - n(jres.points)).max(axis=1)
    assert np.quantile(dp, 0.99) <= 2e-4 and dp.max() <= 2e-3
    np.testing.assert_array_equal(n(tres.obs_inlier), n(jres.obs_inlier))
    np.testing.assert_allclose(float(tres.cost), float(jres.cost), rtol=1e-3)
    # and BA did work: the noisy initial poses moved towards the truth
    assert float(tres.cost) < 0.5 * float(tba._total_cost(
        t(d["poses"]), t(d["points"]), t(d["planes"]),
        tba.BAProblem(**{k: t(v) for k, v in d.items()}), TINTR,
        t(d["obs_valid"].astype(np.float32)), t(np.ones_like(d["pobs_w"]))))


def test_masked_plane_rows_contribute_zero():
    d = _ba_problem(3)
    rng = np.random.default_rng(3)
    g = dict(d)
    g["planes"] = rng.normal(size=d["planes"].shape).astype(np.float32)
    g["pobs_cam"] = rng.integers(0, 6, d["pobs_cam"].shape).astype(np.int32)
    g["pobs_plane"] = rng.integers(0, 3, d["pobs_plane"].shape).astype(np.int32)
    g["pobs_pi"] = rng.normal(size=d["pobs_pi"].shape).astype(np.float32)
    g["pobs_w"] = rng.uniform(1, 1e4, d["pobs_w"].shape).astype(np.float32)
    g["pp_w"] = rng.uniform(1, 10, d["pp_w"].shape).astype(np.float32)
    a, _ = _run_both(d)
    b = tba.bundle_adjust(tba.BAProblem(**{k: t(v) for k, v in g.items()}), TINTR, 4, 6)
    for x, y in zip(a, b):
        if x is not a.planes:
            np.testing.assert_array_equal(n(x), n(y))
    # against the reference, which evaluates the (masked) plane terms
    jb = jba.bundle_adjust(jba.BAProblem(**{k: jnp.asarray(v) for k, v in g.items()}), JINTR,
                           stage1_iters=4, stage2_iters=6)
    np.testing.assert_allclose(n(b.poses), n(jb.poses), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(n(b.pobs_inlier), n(jb.pobs_inlier))
    # one valid observation of a pinned (invalid) plane: a live plane row
    # in the camera block, held against the reference
    g["pobs_valid"] = np.arange(len(g["pobs_valid"])) == 0
    c = tba.bundle_adjust(tba.BAProblem(**{k: t(v) for k, v in g.items()}), TINTR, 2, 2)
    jc = jba.bundle_adjust(jba.BAProblem(**{k: jnp.asarray(v) for k, v in g.items()}), JINTR,
                           stage1_iters=2, stage2_iters=2)
    np.testing.assert_allclose(n(c.poses), n(jc.poses), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(n(c.pobs_inlier), n(jc.pobs_inlier))
    np.testing.assert_array_equal(n(c.obs_inlier), n(jc.obs_inlier))


def test_scatter_and_inverse_helpers():
    rng = np.random.default_rng(4)
    S = np.zeros((40, 40), np.float32)
    rows = rng.integers(0, 6, 30).astype(np.int32) * 6
    blocks = rng.normal(size=(30, 6, 6)).astype(np.float32)
    np.testing.assert_allclose(
        n(tba._scatter_block_add(t(S), t(rows).long(), t(rows).long(), t(blocks))),
        n(jba._scatter_block_add(jnp.asarray(S), jnp.asarray(rows), jnp.asarray(rows),
                                 jnp.asarray(blocks))), rtol=1e-5, atol=1e-5)
    vecs = rng.normal(size=(30, 6)).astype(np.float32)
    np.testing.assert_allclose(
        n(tba._scatter_vec_add(t(np.zeros(40, np.float32)), t(rows).long(), t(vecs))),
        n(jba._scatter_vec_add(jnp.zeros(40), jnp.asarray(rows), jnp.asarray(vecs))),
        rtol=1e-5, atol=1e-5)
    A = rng.normal(size=(64, 3, 3)).astype(np.float32)
    A = A @ np.swapaxes(A, -1, -2) + np.eye(3, dtype=np.float32)
    A[0] = 0.0                                        # singular -> zero inverse
    np.testing.assert_allclose(n(tba._inv3x3(t(A))), n(jba._inv3x3(jnp.asarray(A))),
                               rtol=1e-5, atol=1e-5)
    assert not n(tba._inv3x3(t(A)))[0].any()


def _fuse_scene(seed, n_pts=96, n_kp=128):
    """Two keyframes seeing the same structure, each holding its own copy of
    every landmark (built identically in a JAX store and a port store)."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                    rng.uniform(4, 7, n_pts)], -1).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (n_pts, 8), dtype=np.uint32)
    poses = [np.array([1, 0, 0, 0, 0, 0, 0], np.float32),
             np.asarray(jlie.se3_exp(jnp.asarray([0.08, 0.0, 0.0, 0.0, 0.15, 0.0])))]
    noise = rng.normal(0, 0.01, pts.shape).astype(np.float32)
    stores = []
    for mod in (jstore, tstore):
        st = mod.MapStore(mod.MapConfig(max_keyframes=16, max_points=1024, n_kp=n_kp))
        for c, T in enumerate(poses):
            xc = np.asarray(jlie.se3_apply(jnp.asarray(T), jnp.asarray(pts)))
            uv = np.stack([525 * xc[:, 0] / xc[:, 2] + 319.5,
                           525 * xc[:, 1] / xc[:, 2] + 239.5], -1).astype(np.float32)
            fr = dict(uv=np.zeros((n_kp, 2), np.float32), octave=np.zeros(n_kp, np.int32),
                      angle=np.zeros(n_kp, np.float32), desc=np.zeros((n_kp, 8), np.uint32),
                      depth=np.zeros(n_kp, np.float32), u_right=np.full(n_kp, -1.0, np.float32),
                      valid=np.zeros(n_kp, bool))
            fr["uv"][:n_pts], fr["desc"][:n_pts] = uv, desc
            fr["depth"][:n_pts], fr["valid"][:n_pts] = xc[:, 2], True
            kf = st.add_keyframe(T, float(c), fr, c)
            pos_w = pts if c == 0 else pts + noise
            C = np.asarray(jlie.se3_inverse(jnp.asarray(T)))[4:7]
            vec = pos_w - C
            dist = np.linalg.norm(vec, axis=-1)
            st.add_points_bulk(pos_w, desc, vec / dist[:, None], dist, kf,
                               np.arange(n_pts), octave=np.zeros(n_pts, np.int32))
        stores.append(st)
    return stores


def test_fuse_match_batch_and_search_in_neighbors():
    jst, tst = _fuse_scene(0)
    pids = np.nonzero(tst.pt_valid)[0]
    kfs = np.array([0, 1], np.int32)
    jb = jfuse._kf_stack(jst, kfs)
    tb = tfuse._kf_stack(tst, kfs, DEV)
    _, jpack, jdesc = jfuse._point_block(jst, pids)
    _, tpack, tdesc = tfuse._point_block(tst, pids, DEV)
    ji, jd = jfuse._fuse_match_batch(*jb[1:], jpack, jdesc, JINTR)
    ti, td = tfuse._fuse_match_batch(*tb[1:], tpack, tdesc, TINTR)
    np.testing.assert_array_equal(n(ti), n(ji))
    np.testing.assert_array_equal(n(td), n(jd))
    assert (n(ti) >= 0).sum() > 50
    # the whole fusion (kf 0's points into kf 1, where each has a duplicate)
    # leaves identical maps
    own = jst.kf_obs[0][jst.kf_obs[0] >= 0]
    rj = jfuse.fuse_into_keyframes(jst, JINTR, own, np.array([1], np.int32))
    rt = tfuse.fuse_into_keyframes(tst, TINTR, own, np.array([1], np.int32), DEV)
    assert rt == rj and rt[0] > 50
    for k in ("kf_obs", "pt_valid", "pt_obs_kf", "pt_n_obs", "pt_desc", "pt_normal"):
        np.testing.assert_array_equal(getattr(tst, k), getattr(jst, k), err_msg=k)
    assert tfuse.search_in_neighbors(tst, TINTR, 1, DEV) == jfuse.search_in_neighbors(
        jst, JINTR, 1)


def test_store_from_numpy_roundtrip(tmp_path):
    jst, _ = _fuse_scene(1)
    path = str(tmp_path / "m.npz")
    np.savez_compressed(path, **{k: getattr(jst, k) for k in tstore.SAVED_ARRAYS},
                        n_kf=jst.n_kf, n_pt=jst.n_pt, n_pl=jst.n_pl)
    with np.load(path) as data:
        st = tstore.MapStore.from_numpy(data)
    assert (st.n_kf, st.n_pt, st.cfg.n_kp) == (jst.n_kf, jst.n_pt, 128)
    for k in tstore.SAVED_ARRAYS:
        np.testing.assert_array_equal(getattr(st, k), getattr(jst, k), err_msg=k)
    np.testing.assert_array_equal(st.covisibility(0, 5), jst.covisibility(0, 5))
    with pytest.raises(ValueError):
        tstore.MapStore.from_numpy({"n_kf": 1})
