"""Parity of the port's ops/match and solver/pose_opt (and the tracker's
projection) against spslam_tpu on the CPU.

Tolerances: Hamming distances exact (integer-valued float32 products of
{0,1} vectors); match indices identical, including on matrices full of
tied distances (both take the first index); pose_optimization poses within
1e-5 (float32 sums over hundreds of residuals in another order) and the
inlier sets equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spslam_tpu.geometry import camera as jcam
from spslam_tpu.geometry import lie as jlie
from spslam_tpu.ops import match as jmatch
from spslam_tpu.solver import pose_opt as jpo
from spslam_tpu.tracking import tracker as jtr
from spslam_tpu_torch.geometry import camera as tcam
from spslam_tpu_torch.ops import match as tmatch
from spslam_tpu_torch.solver import pose_opt as tpo
from spslam_tpu_torch.tracking import tracker as ttr
from tests.test_torch_common import n, t

JINTR = jcam.Intrinsics(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0, width=640, height=480)
TINTR = tcam.Intrinsics(*JINTR)


def _bits(rng, k, p=0.5):
    return (rng.uniform(size=(k, 256)) < p).astype(np.float32)


def test_hamming_exact():
    rng = np.random.default_rng(0)
    a, b = _bits(rng, 200), _bits(rng, 300)
    got = n(tmatch.hamming_matrix(t(a), t(b)))
    np.testing.assert_array_equal(got, n(jmatch.hamming_matrix(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(got, (a[:, None, :] != b[None, :, :]).sum(-1))


def test_argmin_takes_first_index_on_ties():
    d = torch.tensor([[3.0, 1.0, 1.0, 1.0], [2.0, 2.0, 2.0, 2.0], [5.0, 4.0, 0.0, 0.0]])
    assert torch.argmin(d, dim=-1).tolist() == [1, 0, 2]
    assert torch.argmin(d, dim=0).tolist() == [1, 0, 2, 2]
    best, idx, second = tmatch._top2(d)
    jb, ji, js = jmatch._top2(jnp.asarray(n(d)))
    np.testing.assert_array_equal(n(idx), n(ji))
    np.testing.assert_array_equal(n(second), n(js))


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("ratio,max_dist", [(0.85, 50.0), (1.0, 100.0), (0.95, 100.0)])
def test_match_descriptors_tie_heavy(seed, ratio, max_dist):
    rng = np.random.default_rng(seed)
    # duplicated columns (exactly tied best distances) and integer distances
    # with many equal values elsewhere
    base = _bits(rng, 200)
    b = np.concatenate([base[:180], base[rng.integers(0, 180, 40)]])
    a = base[rng.integers(0, 200, 150)].copy()
    flip_a = rng.uniform(size=a.shape) < 0.02
    a[flip_a] = 1 - a[flip_a]
    va = rng.uniform(size=150) < 0.9
    vb = rng.uniform(size=220) < 0.9
    gate = rng.uniform(size=(150, 220)) < 0.6
    got = tmatch.match_descriptors(t(a), t(b), t(va), t(vb), max_dist=max_dist, ratio=ratio,
                                   gate=t(gate))
    want = jmatch.match_descriptors(jnp.asarray(a), jnp.asarray(b), jnp.asarray(va),
                                    jnp.asarray(vb), max_dist=max_dist, ratio=ratio,
                                    check_rotation=False, gate=jnp.asarray(gate))
    for x, y in zip(got, want):
        np.testing.assert_array_equal(n(x), n(y))
    assert n(want.valid).sum() > 5


def test_search_by_projection():
    rng = np.random.default_rng(5)
    kp_uv = rng.uniform(0, 640, (300, 2)).astype(np.float32)
    kp_oct = rng.integers(0, 8, 300).astype(np.int32)
    kp_bits = _bits(rng, 300)
    pick = rng.integers(0, 300, 500)
    proj_uv = (kp_uv[pick] + rng.normal(0, 3, (500, 2))).astype(np.float32)
    proj_oct = np.clip(kp_oct[pick] + rng.integers(-1, 2, 500), 0, 7).astype(np.int32)
    proj_bits = kp_bits[pick].copy()
    flip = rng.uniform(size=proj_bits.shape) < 0.1
    proj_bits[flip] = 1 - proj_bits[flip]
    radius = (6.0 * 1.2 ** proj_oct).astype(np.float32)
    pv, kv = rng.uniform(size=500) < 0.95, rng.uniform(size=300) < 0.95
    got = tmatch.search_by_projection(t(proj_uv), t(proj_bits), t(pv), t(proj_oct), t(kp_uv),
                                      t(kp_bits), t(kv), t(kp_oct), t(radius), ratio=0.95)
    z = jnp.zeros(500, jnp.float32)
    want = jmatch.search_by_projection(
        jnp.asarray(proj_uv), jnp.asarray(proj_bits), jnp.asarray(pv), jnp.asarray(proj_oct),
        jnp.asarray(kp_uv), jnp.asarray(kp_bits), jnp.asarray(kv), jnp.asarray(kp_oct),
        jnp.zeros(300, jnp.float32), z, jnp.asarray(radius), ratio=0.95, check_rotation=False)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(n(x), n(y))


def _pnp_problem(seed, n_pts=400, outliers=0.15):
    rng = np.random.default_rng(seed)
    T_true = np.asarray(jlie.se3_exp(jnp.asarray(
        np.array([0.1, -0.05, 0.2, 0.03, -0.02, 0.05], np.float32))))
    pts_c = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                      rng.uniform(1.5, 6, n_pts)], -1).astype(np.float32)
    pts_w = np.asarray(jlie.se3_apply(jlie.se3_inverse(jnp.asarray(T_true)), jnp.asarray(pts_c)))
    uv = np.stack([525 * pts_c[:, 0] / pts_c[:, 2] + 319.5,
                   525 * pts_c[:, 1] / pts_c[:, 2] + 239.5], -1)
    uv = (uv + rng.normal(0, 0.7, uv.shape)).astype(np.float32)
    bad = rng.uniform(size=n_pts) < outliers
    uv[bad] += rng.uniform(15, 40, (bad.sum(), 2)).astype(np.float32)
    ur = np.where(rng.uniform(size=n_pts) < 0.7, uv[:, 0] - 40.0 / pts_c[:, 2], -1.0)
    octv = rng.integers(0, 8, n_pts).astype(np.int32)
    inv_s2 = (1.2 ** (-2.0 * octv)).astype(np.float32)
    valid = rng.uniform(size=n_pts) < 0.9
    T0 = np.asarray(jlie.se3_retract(jnp.asarray(T_true), jnp.asarray(
        rng.normal(0, 0.03, 6).astype(np.float32))))
    return T_true, (T0, pts_w, uv, ur.astype(np.float32), inv_s2, valid)


@pytest.mark.parametrize("seed,rounds,iters", [(0, 4, 10), (1, 2, 5), (2, 4, 10)])
def test_pose_optimization(seed, rounds, iters):
    T_true, args = _pnp_problem(seed)
    got = tpo.pose_optimization(*[t(a) for a in args], TINTR, n_rounds=rounds, n_iters=iters)
    want = jpo.pose_optimization(*[jnp.asarray(a) for a in args], JINTR, n_rounds=rounds,
                                 n_iters=iters)
    np.testing.assert_allclose(n(got.T_cw), n(want.T_cw), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(n(got.inliers), n(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers)
    np.testing.assert_allclose(n(got.T_cw)[4:], T_true[4:], atol=0.02)


def test_residuals_and_jacobian():
    _, (T0, pts_w, uv, ur, _, _) = _pnp_problem(7)
    a = tpo._residuals_and_jac(t(T0), t(pts_w), t(uv), t(ur), TINTR)
    b = jpo._residuals_and_jac(jnp.asarray(T0), jnp.asarray(pts_w), jnp.asarray(uv),
                               jnp.asarray(ur), JINTR)
    for x, y in zip(a, b):
        np.testing.assert_allclose(n(x), n(y), rtol=1e-5, atol=1e-3)


def test_project_points_and_compact_opt():
    _, (T0, pts_w, uv, ur, inv_s2, valid) = _pnp_problem(9, n_pts=600)
    rng = np.random.default_rng(9)
    normal = -pts_w / np.linalg.norm(pts_w, axis=-1, keepdims=True)
    dist = np.linalg.norm(pts_w, axis=-1).astype(np.float32)
    mind, maxd = (dist * 0.5).astype(np.float32), (dist * rng.uniform(0.9, 3, 600)).astype(np.float32)
    a = ttr.project_points(t(T0), t(pts_w), t(normal), t(mind), t(maxd), t(valid), TINTR)
    b = jtr.project_points(jnp.asarray(T0), jnp.asarray(pts_w), jnp.asarray(normal),
                           jnp.asarray(mind), jnp.asarray(maxd), jnp.asarray(valid), JINTR)
    np.testing.assert_allclose(n(a[0]), n(b[0]), rtol=1e-6, atol=1e-3)
    for x, y in zip(a[1:3], b[1:3]):
        np.testing.assert_array_equal(n(x), n(y))
    # compaction: 600 rows, at most 256 matched -> LM over 256 rows
    matched = valid & (rng.uniform(size=600) < 0.4)
    got = ttr._compact_pose_opt(t(T0), t(pts_w), t(uv), t(ur), t(inv_s2), t(matched), 256,
                                TINTR, 2, 5)
    want = jtr._compact_pose_opt(jnp.asarray(T0), jnp.asarray(pts_w), jnp.asarray(uv),
                                 jnp.asarray(ur), jnp.asarray(inv_s2), jnp.asarray(matched),
                                 256, JINTR, 2, 5)
    np.testing.assert_allclose(n(got.T_cw), n(want.T_cw), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(n(got.inliers), n(want.inliers))
