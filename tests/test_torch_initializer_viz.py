"""The port's two-view initializer (spslam_tpu_torch/solver/initializer.py)
and picture writers (viz/draw.py) against spslam_tpu on the CPU.

* `initialize_two_view` with the reference's hypothesis draw fed in
  (jax.random.categorical under PRNGKey(2)): R within 1e-4, the unit
  translation within 1e-4, the same inlier mask; with the port's own draw,
  tests/unit/test_initializer.py's gates (> 150 inliers, translation
  cosine > 0.99, rotation < 1 degree).  E itself is compared up to sign
  and scale (SVD signs are not unique): 1e-4 after normalisation.
* draw.py: the same PNG, pixel for pixel.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spslam_tpu.geometry import Intrinsics as JIntr, project, quat_to_mat, se3_apply, se3_exp
from spslam_tpu.map.store import MapConfig as JMapConfig, MapStore as JMapStore
from spslam_tpu.solver import initializer as jinit
from spslam_tpu.viz import draw as jdraw
from spslam_tpu_torch.geometry.camera import Intrinsics
from spslam_tpu_torch.geometry.lie import quat_to_mat as t_quat_to_mat
from spslam_tpu_torch.solver import initializer as tinit
from spslam_tpu_torch.viz import draw as tdraw
from tests.test_torch_common import n, t
from tests.test_torch_dist_gba import copy_store
from tests.unit import test_global_ba as jscene

J_INTR = JIntr(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480)
INTR = Intrinsics(*J_INTR)


def _scene(seed, N=256, n_out=40, n_invalid=0):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-3, 3, N), rng.uniform(-2, 2, N), rng.uniform(3, 8, N)],
                   -1).astype(np.float32)
    T21 = se3_exp(jnp.array([0.3, 0.05, 0.02, 0.02, 0.08, 0.01]))
    uv1 = np.array(project(J_INTR, jnp.array(pts)))
    uv2 = np.array(project(J_INTR, se3_apply(T21, jnp.array(pts))))
    uv1 += rng.normal(0, 0.3, uv1.shape)
    uv2 += rng.normal(0, 0.3, uv2.shape)
    out = rng.choice(N, n_out, replace=False)
    uv2[out] += rng.uniform(30, 120, (n_out, 2))
    valid = np.ones(N, bool)
    valid[rng.choice(N, n_invalid, replace=False)] = False
    return uv1.astype(np.float32), uv2.astype(np.float32), valid, np.asarray(T21)


def _rot_angle_deg(q_est, q_true):
    R_est = np.asarray(quat_to_mat(jnp.array(q_est)))
    R_true = np.asarray(quat_to_mat(jnp.array(q_true)))
    return np.degrees(np.arccos(np.clip((np.trace(R_est.T @ R_true) - 1) / 2, -1, 1)))


@pytest.mark.parametrize("seed,n_invalid", [(9, 0), (3, 30)])
def test_initialize_two_view_matches_reference(seed, n_invalid):
    uv1, uv2, valid, _ = _scene(seed, n_invalid=n_invalid)
    key = jax.random.PRNGKey(2)
    want = jinit.initialize_two_view(jnp.array(uv1), jnp.array(uv2), jnp.array(valid), J_INTR,
                                     key)
    # the reference's draw, as initialize_two_view makes it
    logits = jnp.where(jnp.array(valid), 0.0, -jnp.inf)
    idx = np.asarray(jax.random.categorical(key, logits, shape=(128, 8)))
    got = tinit.initialize_two_view(t(uv1), t(uv2), t(valid), INTR,
                                    draw=lambda v: torch.from_numpy(idx.copy()))
    Rg = n(t_quat_to_mat(got.T_21[:4]))
    Rw = np.asarray(quat_to_mat(want.T_21[:4]))
    np.testing.assert_allclose(Rg, Rw, atol=1e-4)
    tg, tw = n(got.T_21[4:]), np.asarray(want.T_21[4:])
    np.testing.assert_allclose(tg / np.linalg.norm(tg), tw / np.linalg.norm(tw), atol=1e-4)
    np.testing.assert_array_equal(n(got.inliers), np.asarray(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers)


def test_eight_point_up_to_sign_and_scale():
    uv1, uv2, valid, _ = _scene(9, n_out=0)
    x1, x2 = tinit._normalized(INTR, t(uv1)), tinit._normalized(INTR, t(uv2))
    jx1, jx2 = jinit._normalized(J_INTR, jnp.array(uv1)), jinit._normalized(J_INTR, jnp.array(uv2))
    for rows in (np.arange(8), np.arange(0, 256, 3)):
        Eg = n(tinit._eight_point(x1[rows], x2[rows]))
        Ew = np.asarray(jinit._eight_point(jx1[rows], jx2[rows]))
        Eg, Ew = Eg / np.linalg.norm(Eg), Ew / np.linalg.norm(Ew)
        np.testing.assert_allclose(Eg * np.sign(np.sum(Eg * Ew)), Ew, atol=1e-4)
    # batched hypotheses as one call
    idx = np.random.default_rng(0).integers(0, 256, (16, 8))
    Eb = n(tinit._eight_point(x1[idx], x2[idx]))
    for h in (0, 15):
        Ew = np.asarray(jinit._eight_point(jx1[idx[h]], jx2[idx[h]]))
        a, b = Eb[h] / np.linalg.norm(Eb[h]), Ew / np.linalg.norm(Ew)
        np.testing.assert_allclose(a * np.sign(np.sum(a * b)), b, atol=1e-4)


def test_initialize_two_view_own_draw_recovers_pose():
    uv1, uv2, valid, T21 = _scene(9)
    res = tinit.initialize_two_view(t(uv1), t(uv2), t(valid), INTR)
    assert int(res.n_inliers) > 150
    t_est = n(res.T_21[4:])
    cos = np.dot(t_est, T21[4:]) / (np.linalg.norm(t_est) * np.linalg.norm(T21[4:]))
    assert cos > 0.99, cos
    assert _rot_angle_deg(n(res.T_21[:4]), T21[:4]) < 1.0


def _same_png(a, b):
    np.testing.assert_array_equal(cv2.imread(a, cv2.IMREAD_UNCHANGED),
                                  cv2.imread(b, cv2.IMREAD_UNCHANGED))


def test_draw_matches_reference(tmp_path):
    saved = jscene.rng
    jscene.rng = np.random.default_rng(7)
    try:
        jst, poses_true, _, _ = jscene.build_store_scene()
    finally:
        jscene.rng = saved
    jst.add_plane(np.array([0.0, 0.0, 1.0, -6.0], np.float32), 0, 5000)
    jst2 = copy_store(jst, JMapStore, JMapConfig)        # a clean copy for the reference
    st = copy_store(jst)
    est = poses_true + np.float32(0.01)
    _same_png(tdraw.draw_map_topdown(st, est, poses_true, str(tmp_path / "m_t.png")),
              jdraw.draw_map_topdown(jst2, est, poses_true, str(tmp_path / "m_j.png")))
    rng = np.random.default_rng(5)
    gray = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    uv = rng.uniform(0, 160, (300, 2)).astype(np.float32)
    valid = rng.uniform(size=300) < 0.7
    matched = rng.uniform(size=300) < 0.5
    _same_png(tdraw.draw_frame(gray, uv, valid, matched, str(tmp_path / "f_t.png")),
              jdraw.draw_frame(gray, uv, valid, matched, str(tmp_path / "f_j.png")))
    label = rng.integers(-1, 8, (15, 20))
    _same_png(tdraw.draw_plane_segmentation(gray, label, path=str(tmp_path / "p_t.png")),
              jdraw.draw_plane_segmentation(gray, label, path=str(tmp_path / "p_j.png")))
