"""The port's sharded bundle adjustment (spslam_tpu_torch/parallel/
dist_ba.py) against spslam_tpu's on the CPU: the problem of
tests/dist/test_dist_ba.py::make_problem through both packages, the JAX
side on conftest's 8 virtual devices, the port's shards on "cpu" entries.

Tolerances:
* `partition_problem`, `assign_segments`: exact (the same numpy code);
* `dist_bundle_adjust` port vs JAX at D = 1, 4, 8: poses 1e-4, points
  1e-3 (the bound tests/test_torch_mapping.py holds the local BA to),
  cost relative 1e-4;
* shard invariance of the port (D = 1 vs 4 vs 8): poses 1e-4;
* two gloo processes with 2 shards each: the cost at least halves, poses
  within 1e-4 of the one-process D = 4 run; a world-size-1 gloo group:
  poses 1e-6 and cost equal to the run without a group (an all_reduce
  over one process returns its input).
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from spslam_tpu.parallel import dist_ba as jd
from spslam_tpu_torch.geometry.camera import Intrinsics
from spslam_tpu_torch.parallel import dist_ba as td
from tests.dist import test_dist_ba as jtest
from tests.dist.test_dist_ba import INTR as J_INTR, max_pose_err
from tests.test_torch_common import n

INTR = Intrinsics(*J_INTR)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_problem(seed=7, **kw):
    """tests/dist/test_dist_ba.py's problem from its own seed, with that
    module's shared generator left as it was (its tests draw from it)."""
    saved = jtest.rng
    jtest.rng = np.random.default_rng(seed)
    try:
        return jtest.make_problem(**kw)
    finally:
        jtest.rng = saved


@pytest.fixture(scope="module")
def problem():
    return make_problem(n_cams=5, n_pts=256)


def _partition(mod, p, D, strategy="segments"):
    poses_init, fixed, pts_init, oc, op, ouv, our = p[:7]
    return mod.partition_problem(poses_init, fixed, pts_init, oc, op, ouv, our,
                                 np.ones(len(oc), np.float32), D, strategy=strategy)


def _port(p, D, n_iters=10):
    poses, points, cost = td.dist_bundle_adjust(_partition(td, p, D), INTR, ["cpu"] * D,
                                                n_iters=n_iters)
    return n(poses), n(points), float(cost)


@pytest.mark.parametrize("D,strategy", [(2, "segments"), (8, "segments"), (8, "round_robin")])
def test_partition_problem_matches_reference(problem, D, strategy):
    want = _partition(jd, problem, D, strategy)
    got = _partition(td, problem, D, strategy)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name), n(getattr(want, name)), err_msg=name)


def test_assign_segments_exact():
    rng = np.random.default_rng(3)
    for n_kfs, n_pts, D in ((40, 4000, 8), (7, 300, 3), (256, 32768, 4)):
        ref = rng.integers(0, n_kfs, n_pts)
        np.testing.assert_array_equal(td.assign_segments(ref, n_kfs, D),
                                      jd.assign_segments(ref, n_kfs, D))
    keys = rng.integers(0, 9, 500)
    np.testing.assert_array_equal(td._cumcount(keys), jd._cumcount(keys))


@pytest.mark.parametrize("D", [1, 4, 8])
def test_dist_bundle_adjust_matches_reference(problem, D):
    jprob = _partition(jd, problem, D)
    mesh = Mesh(np.array(jax.devices()[:D]), ("ba",))
    jposes, jpoints, jcost = jd.dist_bundle_adjust(jprob, J_INTR, mesh, n_iters=10)
    poses, points, cost = _port(problem, D)
    np.testing.assert_allclose(poses, n(jposes), atol=1e-4)
    np.testing.assert_allclose(points, n(jpoints), atol=1e-3)
    assert abs(cost - float(jcost)) <= 1e-4 * float(jcost), (cost, float(jcost))


def test_shard_invariance(problem):
    """The same poses whatever the shard count: the sums only regroup."""
    base = _port(problem, 1)[0]
    for D in (4, 8):
        np.testing.assert_allclose(_port(problem, D)[0], base, atol=1e-4)


@pytest.mark.parametrize("D,strategy", [(2, "segments"), (8, "segments"), (8, "round_robin")])
def test_dist_ba_converges(D, strategy):
    """tests/dist/test_dist_ba.py's convergence gate on its first problem,
    and the JAX run's pose error on the same problem to 1e-4."""
    p = make_problem()
    poses_true = p[7]
    prob = _partition(td, p, D, strategy)
    poses, _, _ = td.dist_bundle_adjust(prob, INTR, ["cpu"] * D, n_iters=12)
    jposes, _, _ = jd.dist_bundle_adjust(_partition(jd, p, D, strategy), J_INTR,
                                         Mesh(np.array(jax.devices()[:D]), ("ba",)), n_iters=12)
    init_err = max_pose_err(p[0], poses_true)
    fin_err = max_pose_err(n(poses), poses_true)
    assert fin_err < init_err * 0.25, (init_err, fin_err)
    assert fin_err < 8e-3
    assert abs(fin_err - max_pose_err(n(jposes), poses_true)) < 1e-4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo(problem, tmp_path):
    """Two processes, 2 shards each, (S, b) and the cost all-reduced over
    gloo: the poses of the one-process D = 4 run."""
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", PYTHONPATH=ROOT)
    worker = os.path.join(ROOT, "tests", "torch_dist_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, str(i), "2", coord, str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "MP_OK" in out, f"worker {i}:\n{out[-4000:]}"
    want = _port(problem, 4, n_iters=6)[0]
    for i in range(2):
        got = np.load(tmp_path / f"rank{i}.npz")
        assert got["cost"] < 0.5 * got["cost0"], (got["cost0"], got["cost"])
        np.testing.assert_allclose(got["poses"], want, atol=1e-4)
        assert got["reduce_calls"] == 2 * 6 + 1      # (S, b) and cost per iteration


def test_world_size_one_group(problem, monkeypatch):
    """A gloo group of one process: the all_reduce path, same result."""
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    plain = _port(problem, 4)
    assert td.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0)     # gloo: no CUDA here
    assert torch.distributed.get_backend() == "gloo"
    try:
        stats = {}
        poses, points, cost = td.dist_bundle_adjust(_partition(td, problem, 4), INTR,
                                                    ["cpu"] * 4, n_iters=10, stats=stats)
    finally:
        torch.distributed.destroy_process_group()
    np.testing.assert_allclose(n(poses), plain[0], atol=1e-6)
    np.testing.assert_allclose(n(points), plain[1], atol=1e-6)
    assert float(cost) == plain[2]
    M = problem[0].shape[0]
    assert stats["all_reduce_calls"] == 2 * 10 + 1
    assert stats["all_reduce_bytes"] == 10 * ((6 * M + 1) * 6 * M + 1) * 4 + 4


def test_init_distributed_noop_without_coordinator(monkeypatch):
    monkeypatch.delenv("SPSLAM_COORDINATOR", raising=False)
    assert td.init_distributed() is False
    assert td.global_mesh("cpu") == [torch.device("cpu")]


def test_global_mesh_without_cuda_raises():
    # None means the card, as for every entry point: no silent CPU fallback
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        td.global_mesh()
