"""The reference's public surface in the port, name for name, each held
against spslam_tpu on the same numpy inputs.

Tolerances: exact for constants, specs, stores, culling and the host-side
integer bookkeeping; 1e-6 relative for float32 arithmetic (pixel scale for
the projection, as in test_torch_geometry.py; the trajectories at the
1e-6 of test_torch_system_loop.py)."""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spslam_tpu.geometry as jgeometry
import spslam_tpu_torch.geometry as tgeometry
from spslam_tpu.eval import ate as jate
from spslam_tpu.geometry import camera as jcam
from spslam_tpu.geometry import lie as jlie
from spslam_tpu.io import synthetic as jsyn
from spslam_tpu.map import store as jstore
from spslam_tpu.mapping import local_mapper as jlm
from spslam_tpu.ops import brief as jbrief
from spslam_tpu.ops import fast as jfast
from spslam_tpu.ops import pyramid as jpyr
from spslam_tpu_torch.eval import ate as tate
from spslam_tpu_torch.geometry import camera as tcam
from spslam_tpu_torch.io import synthetic as tsyn
from spslam_tpu_torch.map import store as tstore
from spslam_tpu_torch.mapping import local_mapper as tlm
from spslam_tpu_torch.ops import brief as tbrief
from spslam_tpu_torch.ops import fast as tfast
from spslam_tpu_torch.ops import pyramid as tpyr
from tests.test_torch_common import DEV, assert_same_store, n, t

ROOT = pathlib.Path(__file__).resolve().parents[1]
JINTR = jcam.Intrinsics(fx=525.0, fy=525.0, cx=319.5, cy=239.5, k1=0.05, bf=40.0)
TINTR = tcam.Intrinsics(*JINTR)
PIX = dict(rtol=1e-6, atol=1e-6 * 640)
rng = np.random.default_rng(5)


def _public_names(pkg: pathlib.Path) -> dict:
    """{module path: public top-level names and Class.method names}; an
    __init__'s re-exports count as its names."""
    out = {}
    for path in pkg.rglob("*.py"):
        names = set()
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                names.add(node.name)
                if isinstance(node, ast.ClassDef):
                    names |= {f"{node.name}.{m.name}" for m in node.body
                              if isinstance(m, ast.FunctionDef)}
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                names |= {x.id for x in targets if isinstance(x, ast.Name)}
            elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
                names |= {a.asname or a.name for a in node.names}
        out[str(path.relative_to(pkg))] = {x for x in names
                                           if not x.split(".")[-1].startswith("_")}
    return out


def test_public_surface_matches_reference():
    """Every public name of every reference module has its counterpart in
    the same port module; the Pallas kernel's module is fast_cuda.py."""
    ref, port = _public_names(ROOT / "spslam_tpu"), _public_names(ROOT / "spslam_tpu_torch")
    missing = {mod: sorted(names - port.get(mod, set())) for mod, names in ref.items()
               if mod != "ops/fast_pallas.py"}
    assert {mod: m for mod, m in missing.items() if m} == {}


def test_geometry_reexports():
    public = {x for x in dir(jgeometry) if not x.startswith("_")}
    for name in public - {"camera", "lie", "plane", "np_lie"}:
        obj = getattr(tgeometry, name)
        assert obj.__module__.startswith("spslam_tpu_torch.geometry."), name


def test_intrinsics_K():
    K = TINTR.K
    assert K.dtype == torch.float32 and K.device == DEV
    np.testing.assert_array_equal(n(K), n(JINTR.K))


def test_project_with_depth():
    xc = np.concatenate([rng.normal(0, 1, (64, 2)), rng.uniform(0.3, 6, (64, 1))],
                        axis=-1).astype(np.float32)
    np.testing.assert_allclose(n(tcam.project_with_depth(TINTR, t(xc))),
                               n(jcam.project_with_depth(JINTR, jnp.asarray(xc))), **PIX)


@pytest.mark.parametrize("args", [(480, 640), (240, 320, 4), (480, 640, 6, 1.3)])
def test_default_spec(args):
    got, want = tpyr.default_spec(*args), jpyr.default_spec(*args)
    assert tuple(got) == tuple(want)
    assert got.level_sizes == want.level_sizes


@pytest.mark.parametrize("name", ["ORIENT_MASK", "ORIENT_X", "ORIENT_Y", "BRIEF_DIFF_MATRIX"])
def test_brief_constants_bit_exact(name):
    got, want = getattr(tbrief, name), n(getattr(jbrief, name))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32 and got.device == DEV
    assert got.shape == want.shape
    np.testing.assert_array_equal(n(got).view(np.uint32), want.view(np.uint32))


def test_arc_len():
    assert tfast.ARC_LEN == jfast.ARC_LEN == 9


@pytest.mark.parametrize("delta", [1, 3])
def test_rpe_rmse(delta):
    gt = np.asarray(jlie.se3_exp(jnp.asarray(rng.normal(0, 0.5, (20, 6)).astype(np.float32))))
    est = np.asarray(jlie.se3_retract(jnp.asarray(gt), jnp.asarray(
        rng.normal(0, 0.01, (20, 6)).astype(np.float32))))
    got, want = tate.rpe_rmse(est, gt, delta), jate.rpe_rmse(est, gt, delta)
    assert got[1].shape == (20 - delta,)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-6)


def _frame(n_kp, seed):
    r = np.random.default_rng(seed)
    return dict(uv=r.uniform(0, 400, (n_kp, 2)).astype(np.float32),
                octave=np.zeros(n_kp, np.int32), angle=np.zeros(n_kp, np.float32),
                desc=r.integers(0, 2 ** 32, (n_kp, 8), np.uint64).astype(np.uint32),
                depth=np.ones(n_kp, np.float32), u_right=np.full(n_kp, -1.0, np.float32),
                valid=np.ones(n_kp, bool))


def _stores(n_kf=4, n_kp=32):
    """(reference, port) stores with the same keyframes."""
    out = []
    for mod in (jstore, tstore):
        st = mod.MapStore(mod.MapConfig(max_keyframes=8, max_points=16, n_kp=n_kp))
        for k in range(n_kf):
            st.add_keyframe(np.array([1, 0, 0, 0, 0.1 * k, 0, 0], np.float32), float(k),
                            _frame(n_kp, k), k)
        out.append(st)
    return out


def test_add_point():
    """add_point calls (past the point capacity) with add_observation
    between them: every point array equal."""
    stores = _stores()
    r = np.random.default_rng(6)
    for i in range(24):
        pos = r.normal(0, 1, 3).astype(np.float32)
        desc = r.integers(0, 2 ** 32, 8, np.uint64).astype(np.uint32)
        normal = r.normal(0, 1, 3).astype(np.float32)
        ref_kf, dist, octave = int(r.integers(4)), float(r.uniform(1, 4)), int(r.integers(8))
        kfs = r.choice(4, 2, replace=False)
        ids = [st.add_point(pos, desc, normal, ref_kf, dist, octave) for st in stores]
        assert ids == [i, i]
        for st in stores:
            for k in kfs:
                st.add_observation(i, int(k), i)
    assert_same_store(stores[1], stores[0])
    assert stores[1].pt_n_obs[:24].tolist() == [2] * 24


def test_on_new_points_then_cull_points():
    """The first run of the port's culling: recent points erased for a poor
    found/visible ratio, then for too few observations at age 2, the rest
    graduating at age 3 -- the same points as the reference's."""
    stores = _stores()
    r = np.random.default_rng(7)
    pos = r.normal(0, 1, (30, 3)).astype(np.float32)
    desc = r.integers(0, 2 ** 32, (30, 8), np.uint64).astype(np.uint32)
    normal = np.tile(np.array([0, 0, 1], np.float32), (30, 1))
    visible = r.integers(1, 12, 30)
    found = np.minimum(r.integers(1, 6, 30), visible)
    seen = [r.choice(30, 20, replace=False), r.choice(30, 12, replace=False)]
    mappers = []
    for st, lm in zip(stores, (jlm, tlm)):
        ids = st.add_points_bulk(pos, desc, normal, np.ones(30, np.float32), 0, np.arange(30))
        st.pt_visible[ids] = visible
        st.pt_found[ids] = found
        for k, pids in enumerate(seen, start=1):
            st.add_observations_bulk(ids[pids], k, pids)
        kw = {} if lm is jlm else {"device": DEV}
        mapper = lm.LocalMapper(lm.MapperConfig(), None, st, **kw)
        mapper.on_new_points(ids, 0)
        mappers.append(mapper)
    erased = []
    for kf in (1, 2, 3):
        for m in mappers:
            m.cull_points(kf)
        assert_same_store(stores[1], stores[0])
        assert mappers[1]._recent_points == mappers[0]._recent_points
        erased.append(int((~stores[1].pt_valid[:30]).sum()))
    # each rule fired: the ratio at once, the observation count at age 2
    assert 0 < erased[0] < erased[1] == erased[2] < 30
    assert mappers[1]._recent_points == []


@pytest.mark.parametrize("call", [
    ("orbit_trajectory", (8, 0.5), {}),
    ("orbit_trajectory", (8,), {"radius": 1.2, "seed": 3}),
    ("orbit_trajectory", (20,), {}),
    ("loop_trajectory", (64, 1.0), {}),
    ("loop_trajectory", (16,), {"turns": 0.5}),
    ("loop_trajectory", (16, 2, 2.0), {}),
    ("loop_trajectory", (12,), {"seed": 3}),
])
def test_trajectory_signatures(call):
    name, args, kw = call
    np.testing.assert_allclose(getattr(tsyn, name)(*args, **kw),
                               getattr(jsyn, name)(*args, **kw), rtol=0, atol=1e-6)
