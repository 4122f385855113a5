"""Parity of the port's identity constructors, SE(3) matrix conversions and
Sim(3) group (geometry/lie.py) against spslam_tpu, at 1e-6 in float32
relative to the unit scale of the operands, on the cases of
tests/unit/test_geometry.py (TestSE3, TestSim3) and at the branch points of
sim3_exp's coefficients: theta = 0, sigma = 0, both, and 1e-7 for each."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spslam_tpu.geometry import lie as jlie
from spslam_tpu_torch.geometry import lie as tlie
from tests.test_torch_common import DEV, n, t

TOL = dict(rtol=1e-6, atol=1e-6)
rng = np.random.default_rng(11)


def _quats(k):
    q = rng.normal(size=(k, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _sim3(k):
    q = _quats(k)
    tr = rng.normal(size=(k, 3)).astype(np.float32)
    s = np.exp(rng.normal(size=(k,)) * 0.3).astype(np.float32)
    return q, tr, s


def both(name, *args):
    """(port, reference) results of lie.<name> on the same numpy inputs."""
    got = getattr(tlie, name)(*[t(a) if isinstance(a, np.ndarray) else a for a in args])
    want = getattr(jlie, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                 for a in args])
    return n(got), n(want)


@pytest.mark.parametrize("name", ["quat_identity", "se3_identity", "sim3_identity"])
def test_identities(name):
    got = getattr(tlie, name)(DEV)
    assert got.dtype == torch.float32 and got.device == DEV
    np.testing.assert_array_equal(n(got), n(getattr(jlie, name)()))


def test_identity_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tlie.sim3_identity()


def test_se3_matrix_and_back():
    T = np.concatenate([_quats(16), rng.normal(size=(16, 3)).astype(np.float32)], axis=-1)
    got, want = both("se3_matrix", T)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(*both("se3_from_matrix", want), **TOL)
    # TestSE3.test_matrix_consistency: the matrix applies the pose
    x = rng.normal(size=(16, 3)).astype(np.float32)
    np.testing.assert_allclose(n(tlie.se3_apply(t(T), t(x))),
                               (got[:, :3, :3] @ x[..., None])[..., 0] + got[:, :3, 3],
                               atol=1e-5)


@pytest.mark.parametrize("s_form", ["array", "trailing", "number"])
def test_sim3_make_and_parts(s_form):
    q, tr, s = _sim3(8)
    s_arg = {"array": s, "trailing": s[:, None], "number": 1.5}[s_form]
    got, want = both("sim3_make", q * 2.0, tr, s_arg)
    assert got.shape == (8, 8)
    np.testing.assert_allclose(got, want, **TOL)
    for part in ("sim3_q", "sim3_t", "sim3_s"):
        np.testing.assert_array_equal(*both(part, want))


def test_sim3_compose_inverse_apply():
    S = n(jlie.sim3_make(*[jnp.asarray(a) for a in _sim3(8)]))
    S2 = n(jlie.sim3_make(*[jnp.asarray(a) for a in _sim3(8)]))
    x = rng.normal(size=(8, 3)).astype(np.float32)
    np.testing.assert_allclose(*both("sim3_compose", S, S2), **TOL)
    np.testing.assert_allclose(*both("sim3_inverse", S), **TOL)
    np.testing.assert_allclose(*both("sim3_apply", S, x), **TOL)
    # TestSim3.test_compose_inverse: S * S^-1 is the identity
    ident = n(tlie.sim3_compose(t(S), tlie.sim3_inverse(t(S))))
    np.testing.assert_allclose(np.abs(ident[:, 0]), 1.0, atol=1e-5)
    np.testing.assert_allclose(ident[:, 4:7], 0.0, atol=1e-4)
    np.testing.assert_allclose(ident[:, 7], 1.0, atol=1e-5)


def test_sim3_apply_scale():
    """TestSim3.test_apply_scale: a pure scale of 2."""
    S = tlie.sim3_make(tlie.quat_identity(DEV), torch.zeros(3), torch.tensor(2.0))
    np.testing.assert_allclose(n(tlie.sim3_apply(S, torch.tensor([1.0, 2.0, 3.0]))),
                               [2, 4, 6], atol=1e-6)


def test_sim3_se3_conversions():
    T = np.concatenate([_quats(8), rng.normal(size=(8, 3)).astype(np.float32)], axis=-1)
    np.testing.assert_array_equal(*both("sim3_from_se3", T))
    S = n(jlie.sim3_make(*[jnp.asarray(a) for a in _sim3(8)]))
    np.testing.assert_allclose(*both("se3_from_sim3", S), **TOL)


def _tangents(theta, sigma, k=16):
    """[k, 7] tangents with |phi| = theta and sigma as given (None: random)."""
    xi = (0.4 * rng.normal(size=(k, 7))).astype(np.float32)
    if theta is not None:
        axis = rng.normal(size=(k, 3))
        xi[:, 3:6] = axis / np.linalg.norm(axis, axis=-1, keepdims=True) * theta
    if sigma is not None:
        xi[:, 6] = sigma * np.sign(rng.normal(size=k))
    return xi


# (theta, sigma): the general branch, then the branch points of sim3_exp
BRANCHES = [(None, None), (0.0, None), (None, 0.0), (0.0, 0.0),
            (1e-7, None), (None, 1e-7), (1e-7, 1e-7), (1e-7, 0.0), (0.0, 1e-7)]


@pytest.mark.parametrize("theta,sigma", BRANCHES)
def test_sim3_exp_log(theta, sigma):
    xi = _tangents(theta, sigma)
    got, want = both("sim3_exp", xi)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(*both("sim3_log", want), **TOL)
    # TestSim3.test_exp_log_roundtrip
    np.testing.assert_allclose(n(tlie.sim3_log(t(got))), xi, atol=2e-4)


def test_sim3_exp_reduces_to_se3():
    """TestSim3.test_exp_reduces_to_se3: sigma = 0 gives the SE(3) exp."""
    xi6 = (0.4 * rng.normal(size=(8, 6))).astype(np.float32)
    xi7 = np.concatenate([xi6, np.zeros((8, 1), np.float32)], axis=-1)
    S = n(tlie.sim3_exp(t(xi7)))
    np.testing.assert_allclose(S[:, :7], n(tlie.se3_exp(t(xi6))), atol=1e-4)
    np.testing.assert_allclose(S[:, 7], 1.0, atol=1e-6)
