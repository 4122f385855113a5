"""Parity of the port's geometry/lie, geometry/camera, geometry/np_lie and
solver/robust against spslam_tpu, at 1e-6 in float32, relative to the
scale of the operands (unit-scale values for the Lie group, pixel
coordinates up to 640 for the camera: the two frameworks may round a
transcendental, a division or a fused multiply-add differently by an ulp,
and uR = u - bf/z cancels pixel-scale terms)."""

import jax.numpy as jnp
import numpy as np
import pytest

from spslam_tpu.geometry import camera as jcam
from spslam_tpu.geometry import lie as jlie
from spslam_tpu.geometry import np_lie as jnp_lie
from spslam_tpu.solver import robust as jrob
from spslam_tpu_torch.geometry import camera as tcam
from spslam_tpu_torch.geometry import lie as tlie
from spslam_tpu_torch.geometry import np_lie as tnp_lie
from spslam_tpu_torch.solver import robust as trob
from tests.test_torch_common import n, t

TOL = dict(rtol=1e-6, atol=1e-6)
PIX = dict(rtol=1e-6, atol=1e-6 * 640)
rng = np.random.default_rng(3)


def _poses(k):
    xi = rng.normal(0, 0.5, (k, 6)).astype(np.float32)
    return np.asarray(jlie.se3_exp(jnp.asarray(xi)))


def _quats(k):
    q = rng.normal(size=(k, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.mark.parametrize("name", ["quat_rotate", "quat_mul", "quat_to_mat", "quat_conj",
                                  "quat_normalize"])
def test_quaternion_ops(name):
    q = _quats(64)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    args = {"quat_rotate": (q, v), "quat_mul": (q, _quats(64)), "quat_to_mat": (q,),
            "quat_conj": (q,), "quat_normalize": (q * 3.0,)}[name]
    got = getattr(tlie, name)(*[t(a) for a in args])
    want = getattr(jlie, name)(*[jnp.asarray(a) for a in args])
    np.testing.assert_allclose(n(got), n(want), **TOL)


def test_mat_to_quat_roundtrip():
    m = np.asarray(jlie.quat_to_mat(jnp.asarray(_quats(64))))
    np.testing.assert_allclose(n(tlie.mat_to_quat(t(m))), n(jlie.mat_to_quat(jnp.asarray(m))),
                               **TOL)


@pytest.mark.parametrize("scale", [1e-7, 1e-3, 0.5, 2.0])
def test_so3_exp_and_se3_exp(scale):
    xi = (rng.normal(size=(32, 6)) * scale).astype(np.float32)
    np.testing.assert_allclose(n(tlie.so3_exp_quat(t(xi[:, 3:]))),
                               n(jlie.so3_exp_quat(jnp.asarray(xi[:, 3:]))), **TOL)
    np.testing.assert_allclose(n(tlie.se3_exp(t(xi))), n(jlie.se3_exp(jnp.asarray(xi))), **TOL)


@pytest.mark.parametrize("name", ["se3_compose", "se3_inverse", "se3_retract"])
def test_se3_ops(name):
    A, B = _poses(32), _poses(32)
    xi = rng.normal(0, 0.1, (32, 6)).astype(np.float32)
    args = {"se3_compose": (A, B), "se3_inverse": (A,), "se3_retract": (A, xi)}[name]
    got = getattr(tlie, name)(*[t(a) for a in args])
    want = getattr(jlie, name)(*[jnp.asarray(a) for a in args])
    np.testing.assert_allclose(n(got), n(want), rtol=1e-6, atol=2e-6)


@pytest.mark.parametrize("name", ["se3_compose", "se3_inverse", "camera_center", "quat_to_mat"])
def test_np_lie_copy_equals_reference(name):
    A, B = _poses(8), _poses(8)
    args = {"se3_compose": (A, B), "se3_inverse": (A,), "camera_center": (A,),
            "quat_to_mat": (A[:, :4],)}[name]
    np.testing.assert_array_equal(getattr(tnp_lie, name)(*args), getattr(jnp_lie, name)(*args))


DIST = jcam.Intrinsics(fx=520.0, fy=515.0, cx=320.5, cy=238.0, k1=0.12, k2=-0.21,
                       p1=0.001, p2=-0.0015, k3=0.05, bf=40.0, width=640, height=480)


@pytest.mark.parametrize("distorted", [False, True])
def test_camera(distorted):
    ji = DIST if distorted else jcam.Intrinsics(fx=525.0, fy=525.0, cx=319.5, cy=239.5)
    ti = tcam.Intrinsics(*ji)
    uv = np.stack([rng.uniform(-5, 645, 256), rng.uniform(-5, 485, 256)], -1).astype(np.float32)
    d = np.where(rng.uniform(size=256) < 0.2, 0.0, rng.uniform(0.3, 6, 256)).astype(np.float32)
    np.testing.assert_allclose(n(tcam.undistort_points(ti, t(uv))),
                               n(jcam.undistort_points(ji, jnp.asarray(uv))), **PIX)
    np.testing.assert_allclose(n(tcam.unproject(ti, t(uv), t(d))),
                               n(jcam.unproject(ji, jnp.asarray(uv), jnp.asarray(d))), **PIX)
    np.testing.assert_allclose(n(tcam.virtual_right_u(ti, t(uv[:, 0]), t(d))),
                               n(jcam.virtual_right_u(ji, jnp.asarray(uv[:, 0]), jnp.asarray(d))),
                               **PIX)
    for border in (0.0, 1.0):
        np.testing.assert_array_equal(n(tcam.in_image(ti, t(uv), border)),
                                      n(jcam.in_image(ji, jnp.asarray(uv), border)))
    assert hash(ti) == hash(tcam.Intrinsics(*ji)) and ti.has_distortion == ji.has_distortion


def test_robust_weights():
    chi2 = np.concatenate([[0.0, 5.991, 7.815], rng.uniform(0, 50, 253)]).astype(np.float32)
    for delta2 in (jrob.CHI2_2D, jrob.CHI2_3D):
        np.testing.assert_allclose(n(trob.huber_weight(t(chi2), delta2)),
                                   n(jrob.huber_weight(jnp.asarray(chi2), delta2)), **TOL)
    octv = np.arange(8, dtype=np.int32)
    np.testing.assert_allclose(n(trob.octave_inv_sigma2(t(octv))),
                               n(jrob.octave_inv_sigma2(jnp.asarray(octv))), **TOL)


def test_solve6():
    A = rng.normal(size=(16, 6, 6)).astype(np.float32)
    H = A @ np.swapaxes(A, -1, -2) + 6 * np.eye(6, dtype=np.float32)
    b = rng.normal(size=(16, 6)).astype(np.float32)
    got = n(trob.solve6(t(H), t(b)))
    np.testing.assert_allclose(got, n(jrob.solve6(jnp.asarray(H), jnp.asarray(b))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.einsum("nij,nj->ni", H, got), b, rtol=1e-4, atol=1e-4)
