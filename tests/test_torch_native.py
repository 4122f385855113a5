"""The port's C++ host library (spslam_tpu_torch/native: BoW inverted
index and covisibility counter, built with g++ into
spslam_tpu_torch/_build/) against spslam_tpu's native index, the port's
pure-Python index and numpy, on the CPU.

Exact: candidates, their order and the counts; scores within 1e-6
(float32 in C++, float64 in Python).
"""

import os

import numpy as np
import pytest

from spslam_tpu.loop import kfdb as jkfdb
from spslam_tpu.map.store import MapConfig as JMapConfig, MapStore as JMapStore
from spslam_tpu_torch.loop import kfdb as tkfdb
from spslam_tpu_torch.map import store as tstore
from spslam_tpu_torch.native import bindings
from tests.test_torch_dist_gba import copy_store
from tests.unit import test_global_ba as jscene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_library_builds_in_the_port():
    assert bindings.get_lib() is not None
    assert os.path.dirname(bindings.LIB_PATH) == os.path.join(ROOT, "spslam_tpu_torch", "_build")
    assert os.path.exists(bindings.build())       # already built: the same path
    assert tkfdb.KeyFrameDatabase().is_native
    assert not tkfdb.KeyFrameDatabase(use_native=False).is_native


def _bow(rng, words):
    v = {int(w): float(x) for w, x in zip(words, rng.uniform(0.5, 1.5, len(words)))}
    s = sum(v.values())
    return {w: x / s for w, x in v.items()}


@pytest.mark.parametrize("seed", [4, 9])
def test_bow_index_matches_reference_and_python(seed):
    rng = np.random.default_rng(seed)
    ref = jkfdb.KeyFrameDatabase(n_words=512, use_native=True)
    assert ref.is_native
    native = tkfdb.KeyFrameDatabase(n_words=512)
    python = tkfdb.KeyFrameDatabase(n_words=512, use_native=False)
    dbs = (ref, native, python)
    base = rng.choice(512, 60, replace=False)
    for k in range(24):
        v = _bow(rng, np.unique(np.concatenate([base[: 60 - 2 * k], rng.choice(512, 2 * k + 5)])))
        for db in dbs:
            db.add(k, v)
    q = _bow(rng, base)

    def check(exclude, min_score, max_results):
        want = ref.query(q, exclude, min_score, max_results)
        for db in (native, python):
            got = db.query(q, exclude, min_score, max_results)
            assert [k for k, _ in got] == [k for k, _ in want]
            np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=1e-6)

    for exclude, min_score in ((set(), 0.0), ({0, 1, 2}, 0.05), ({3}, 0.2), (set(), 0.9)):
        for max_results in (8, 3):
            check(exclude, min_score, max_results)
    for a, b in ((1, 2), (0, 23), (5, 5), (3, 99)):
        want = ref.similarity(a, b)
        assert abs(native.similarity(a, b) - want) < 1e-6
        assert abs(python.similarity(a, b) - want) < 1e-6
    for k in (0, 5, 6, 23, 77):
        for db in dbs:
            db.erase(k)
    check(set(), 0.0, 30)
    assert 5 not in [k for k, _ in native.query(q, set(), 0.0, 30)]
    assert native.query({}, set(), 0.0) == []


def test_covis_count_matches_numpy():
    rng = np.random.default_rng(2)
    n_kf, n_pts, O = 40, 3000, 16
    pt_obs_kf = np.where(rng.uniform(size=(n_pts, O)) < 0.4, rng.integers(0, n_kf, (n_pts, O)), -1)
    kf_obs = np.where(rng.uniform(size=500) < 0.8, rng.integers(0, n_pts, 500), -1)
    for kf in (0, 7, 39):
        got = bindings.covis_count(kf_obs, pt_obs_kf, kf, n_kf)
        pts = kf_obs[kf_obs >= 0]
        obs = pt_obs_kf[pts].ravel()
        want = np.bincount(obs[(obs >= 0) & (obs != kf)], minlength=n_kf)
        np.testing.assert_array_equal(got, want)


def test_store_covisibility_native_equals_numpy_and_reference(monkeypatch):
    saved = jscene.rng
    jscene.rng = np.random.default_rng(7)
    try:
        jst, _, _, _ = jscene.build_store_scene(n_cams=8, n_pts=200)
    finally:
        jscene.rng = saved
    st = copy_store(jst)
    # thin the observations unevenly so the weights differ per keyframe
    rng = np.random.default_rng(1)
    drop = rng.uniform(size=st.pt_obs_kf.shape) < np.linspace(0.0, 0.8, st.pt_obs_kf.shape[1])
    st.pt_obs_kf[drop] = -1
    jst2 = copy_store(st, JMapStore, JMapConfig)
    native = [st.covisibility(k, w) for k in range(8) for w in (1, 50, 150)]
    monkeypatch.setattr(tstore, "covis_count", lambda *a: None)
    plain = [st.covisibility(k, w) for k in range(8) for w in (1, 50, 150)]
    want = [jst2.covisibility(k, w) for k in range(8) for w in (1, 50, 150)]
    for a, b, c in zip(native, plain, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    assert any(len(a) not in (0, 7) for a in native)


def test_database_under_concurrent_add_and_query():
    """The mapping worker adds keyframes while a LOST tracker queries:
    eight threads, a short switch interval, every add present after."""
    import sys
    import threading

    db = tkfdb.KeyFrameDatabase(n_words=512)
    rng = np.random.default_rng(0)
    vecs = [_bow(rng, rng.choice(512, 40, replace=False)) for _ in range(400)]
    errors = []

    def adder(start):
        try:
            for k in range(start, 400, 4):
                db.add(k, vecs[k])
        except Exception as e:       # noqa: BLE001 - reported below
            errors.append(e)

    def querier():
        try:
            for k in range(200):
                db.query(vecs[k], {k}, 0.0, 8)
                db.erase(10_000 + k)     # absent ids: a no-op under the lock
        except Exception as e:       # noqa: BLE001
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=adder, args=(i,)) for i in range(4)]
        threads += [threading.Thread(target=querier) for _ in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(th.is_alive() for th in threads)
    assert sorted(db.bow) == list(range(400))
    got = db.query(vecs[7], set(), 0.0, 1)
    assert got and got[0][0] == 7
