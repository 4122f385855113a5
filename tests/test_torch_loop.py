"""Loop-closure and relocalization modules of the port against spslam_tpu
on the CPU: the same numpy inputs (from seeds) through both packages.

Tolerances, each where it is checked:
* vocabulary: `quantize` and `train_vocab_bits` exact (integer Hamming
  sums), idf exact, BoW vectors and similarities 1e-12 (float64 host code);
* KFDB: the same candidates in the same order as the reference's Python
  index and its native index;
* `rotation_consistency`: masks exact, histogram ties included;
* RANSAC with the reference's hypothesis draw fed in: T_ba 1e-4, equal
  inlier counts; per-hypothesis Horn 1e-4 on triples without a repeated
  index (a repeated one makes Horn degenerate and its SVD not unique);
* `so3_log` / `se3_log` 1e-6; pose-graph edge Jacobians 1e-5 against
  `jax.jacfwd`, at zero and at random residuals; the K=32 drifted loop
  1e-4;
* `refine_alternating` and the global BA: poses 1e-4, points 1e-3 (the
  bound tests/test_torch_mapping.py holds the local BA to);
* the detector's gates exact; `_merge_gba` 1e-5 on the same GBA result.
"""

import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spslam_tpu.geometry import lie as jlie
from spslam_tpu.geometry.camera import Intrinsics as JIntr, project as j_project
from spslam_tpu.loop import kfdb as jkfdb, sim3 as jsim3, vocab as jvocab
from spslam_tpu.loop.loop_closer import LoopCloser as JLoopCloser, LoopConfig as JLoopConfig
from spslam_tpu.map.store import MapConfig as JMapConfig, MapStore as JMapStore
from spslam_tpu.ops import match as jmatch
from spslam_tpu.solver import ba as jba, global_ba as jgba, pose_graph as jpg
from spslam_tpu_torch.geometry import lie as tlie
from spslam_tpu_torch.geometry.camera import Intrinsics, project
from spslam_tpu_torch.loop import kfdb as tkfdb, sim3 as tsim3, vocab as tvocab
from spslam_tpu_torch.loop import loop_closer as tloop
from spslam_tpu_torch.loop.loop_closer import LoopCloser, LoopConfig
from spslam_tpu_torch.map.store import SAVED_ARRAYS, SAVED_COUNTS, MapConfig, MapStore
from spslam_tpu_torch.ops import match as tmatch
from spslam_tpu_torch.solver import ba as tba, global_ba as tgba, pose_graph as tpg
from tests.test_torch_common import DEV, n, t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests", "unit"))
sys.path.insert(0, os.path.join(ROOT, "tests", "integration"))

from test_global_ba import INTR as J_GBA_INTR, build_store_scene, pose_err  # noqa: E402

GBA_INTR = Intrinsics(*J_GBA_INTR)
VOCAB = os.path.join(ROOT, "data", "vocab_synth.npz")


def port_store(jst) -> MapStore:
    """A port MapStore holding a copy of a JAX-package store's arrays."""
    data = {k: getattr(jst, k) for k in SAVED_ARRAYS + SAVED_COUNTS}
    st = MapStore.from_numpy(data, MapConfig(max_obs_per_point=jst.cfg.max_obs_per_point))
    st.ppe_a, st.ppe_b, st.ppe_type = jst.ppe_a.copy(), jst.ppe_b.copy(), jst.ppe_type.copy()
    return st


def rand_bits(rng, shape):
    return (rng.uniform(size=shape) > 0.5).astype(np.float32)


# ---------------------------------------------------------------- vocabulary
def test_quantize_exact():
    rng = np.random.default_rng(0)
    bits = rand_bits(rng, (600, 256))
    voc = rand_bits(rng, (300, 256))
    voc[7] = voc[3]                         # duplicate words: argmin ties
    bits[:20] = voc[3]
    valid = rng.uniform(size=600) > 0.1
    want = n(jvocab.quantize(jnp.asarray(bits), jnp.asarray(voc), jnp.asarray(valid)))
    got = n(tvocab.quantize(t(bits), t(voc), t(valid)))
    np.testing.assert_array_equal(got, want)
    assert (got[:20][valid[:20]] == 3).all()


def test_train_vocab_bits_with_injected_draw():
    rng = np.random.default_rng(1)
    protos = rng.integers(0, 2, (32, 256)).astype(np.float32)
    data = np.repeat(protos, 40, axis=0)
    data = np.where(rng.uniform(size=data.shape) < 0.05, 1 - data, data).astype(np.float32)
    key = jax.random.PRNGKey(0)
    init = n(jax.random.choice(key, len(data), (32,), replace=False))
    want = n(jvocab.train_vocab_bits(jnp.asarray(data), key, n_words=32))
    got = n(tvocab.train_vocab_bits(t(data), 32, init_idx=torch.from_numpy(np.array(init))))
    np.testing.assert_array_equal(got, want)


def test_vocabulary_train_idf_with_injected_draw():
    rng = np.random.default_rng(2)
    descs = rng.integers(0, 2 ** 32, (1500, 8), dtype=np.uint32)
    jv = jvocab.Vocabulary(n_words=64, train_after=10 ** 9)
    tv = tvocab.Vocabulary(n_words=64, train_after=10 ** 9, device=DEV)
    jv.add_training_descriptors(descs)
    tv.add_training_descriptors(descs)
    jv.train()
    init = n(jax.random.choice(jax.random.PRNGKey(jv.seed), 1500, (64,), replace=False))
    tv.train(init_idx=torch.from_numpy(np.array(init)))
    np.testing.assert_array_equal(n(tv.vocab_bits), n(jv.vocab_bits))
    np.testing.assert_array_equal(tv.idf, jv.idf)
    # the port's own draw: distinct rows from a seeded generator
    own = tvocab.Vocabulary(n_words=64, train_after=1000, device=DEV)
    own.add_training_descriptors(descs)
    assert own.trained and own.vocab_bits.shape == (64, 256)


def test_bow_vector_and_similarity():
    rng = np.random.default_rng(3)
    jv = jvocab.Vocabulary(n_words=4096)
    jv.load(VOCAB)
    tv = tvocab.Vocabulary(n_words=4096, device=DEV)
    tv.load(VOCAB)
    vecs = []
    for size in (700, 1024, 300):
        d = rng.integers(0, 2 ** 32, (size, 8), dtype=np.uint32)
        a, b = jv.bow_vector(d), tv.bow_vector(d)
        assert sorted(a) == sorted(b)
        for w in a:
            assert abs(a[w] - b[w]) <= 1e-12
        vecs.append((a, b))
    # a shared half makes the scores non-trivial
    d0 = rng.integers(0, 2 ** 32, (800, 8), dtype=np.uint32)
    d1 = np.concatenate([d0[:400], rng.integers(0, 2 ** 32, (400, 8), dtype=np.uint32)])
    vecs.append((jv.bow_vector(d1), tv.bow_vector(d1)))
    vecs.append((jv.bow_vector(d0), tv.bow_vector(d0)))
    for (ja, ta) in vecs:
        for (jb, tb) in vecs:
            assert abs(jvocab.bow_similarity(ja, jb) - tvocab.bow_similarity(ta, tb)) <= 1e-12
    assert tvocab.bow_similarity(vecs[-1][1], vecs[-2][1]) > 0.2
    assert tvocab.bow_similarity({}, vecs[0][1]) == 0.0
    assert tv.bow_vector(np.zeros((0, 8), np.uint32)) == {}


# ---------------------------------------------------------------- KFDB
@pytest.mark.parametrize("native", [False, True])
def test_kfdb_query_and_erase_match_reference(native):
    rng = np.random.default_rng(4)
    ref = jkfdb.KeyFrameDatabase(n_words=512, use_native=native)
    assert ref.is_native == native
    port = tkfdb.KeyFrameDatabase()

    def bow(words):
        v = {int(w): float(x) for w, x in zip(words, rng.uniform(0.5, 1.5, len(words)))}
        s = sum(v.values())
        return {w: x / s for w, x in v.items()}

    base = rng.choice(512, 60, replace=False)
    for k in range(24):
        words = np.unique(np.concatenate([base[: 60 - 2 * k], rng.choice(512, 2 * k + 5)]))
        v = bow(words)
        ref.add(k, v)
        port.add(k, v)
    q = bow(base)
    for exclude, min_score in ((set(), 0.0), ({0, 1, 2}, 0.05), ({3}, 0.2), (set(), 0.9)):
        for max_results in (8, 3):
            want = ref.query(q, exclude, min_score, max_results)
            got = port.query(q, exclude, min_score, max_results)
            assert [k for k, _ in got] == [k for k, _ in want]
            np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=1e-6)
    for k in (0, 5, 6, 23):
        ref.erase(k)
        port.erase(k)
    want = ref.query(q, set(), 0.0, 30)
    got = port.query(q, set(), 0.0, 30)
    assert [k for k, _ in got] == [k for k, _ in want] and 5 not in [k for k, _ in got]
    assert abs(tvocab.bow_similarity(port.bow[1], port.bow[2]) - ref.similarity(1, 2)) < 1e-6
    assert port.query({}, set(), 0.0) == []


def test_store_erase_hook_drops_keyframe_from_database():
    st = MapStore(MapConfig(max_keyframes=8, max_points=64, n_kp=16))
    lc = LoopCloser(GBA_INTR, st, cfg=LoopConfig(), device=DEV)
    frame_np = dict(uv=np.zeros((16, 2), np.float32), octave=np.zeros(16, np.int32),
                    angle=np.zeros(16, np.float32), desc=np.zeros((16, 8), np.uint32),
                    depth=np.ones(16, np.float32), u_right=np.full(16, -1.0, np.float32),
                    valid=np.ones(16, bool))
    for k in range(3):
        st.add_keyframe(np.array([1, 0, 0, 0, 0, 0, 0], np.float32), float(k), frame_np, k)
        lc.kfdb.add(k, {1: 0.5, 2 + k: 0.5})
    st.erase_keyframe(1)
    assert 1 not in lc.kfdb.bow and 1 not in lc.kfdb.inverted[1]
    assert [k for k, _ in lc.kfdb.query({1: 1.0}, set(), 0.0)] == [0, 2]


# ---------------------------------------------------------------- matching
def test_rotation_consistency_exact_with_ties():
    rng = np.random.default_rng(5)
    N = 120
    ang_b = rng.uniform(0, 2 * np.pi, N).astype(np.float32)
    # bins 4, 9, 17, 22 all hold 20 votes: a four-way tie for the top 3
    bins = np.repeat([4, 9, 17, 22, 1, 28], 20)
    diff = ((bins + 0.5) / 30.0 * 2 * np.pi).astype(np.float32)
    ang_a = (ang_b + diff).astype(np.float32)
    for valid in (np.ones(N, bool), rng.uniform(size=N) > 0.3):
        want = n(jmatch.rotation_consistency(jnp.asarray(ang_a), jnp.asarray(ang_b),
                                             jnp.asarray(valid)))
        got = n(tmatch.rotation_consistency(t(ang_a), t(ang_b), t(valid)))
        np.testing.assert_array_equal(got, want)
    # negative differences wrap like jnp.mod
    neg = (ang_b - diff).astype(np.float32)
    np.testing.assert_array_equal(
        n(tmatch.rotation_consistency(t(neg), t(ang_b), t(np.ones(N, bool)))),
        n(jmatch.rotation_consistency(jnp.asarray(neg), jnp.asarray(ang_b),
                                      jnp.asarray(np.ones(N, bool)))))


def _match_inputs(seed, na=200, nb=220):
    rng = np.random.default_rng(seed)
    bits_b = rand_bits(rng, (nb, 256))
    perm = rng.permutation(nb)[:na]
    flips = rng.uniform(size=(na, 256)) < 0.08
    bits_a = np.where(flips, 1 - bits_b[perm], bits_b[perm]).astype(np.float32)
    ang_b = rng.uniform(0, 2 * np.pi, nb).astype(np.float32)
    ang_a = (ang_b[perm] + 0.3 + np.where(rng.uniform(size=na) < 0.3,
                                           rng.uniform(0, 6, na), 0.0)).astype(np.float32)
    return bits_a, bits_b, rng.uniform(size=na) > 0.1, rng.uniform(size=nb) > 0.1, ang_a, ang_b


@pytest.mark.parametrize("seed", [0, 1])
def test_match_descriptors_rotation_check(seed):
    bits_a, bits_b, va, vb, ang_a, ang_b = _match_inputs(seed)
    want = jmatch.match_descriptors(jnp.asarray(bits_a), jnp.asarray(bits_b), jnp.asarray(va),
                                    jnp.asarray(vb), jnp.asarray(ang_a), jnp.asarray(ang_b),
                                    max_dist=64.0, ratio=0.85)
    got = tmatch.match_descriptors(t(bits_a), t(bits_b), t(va), t(vb), t(ang_a), t(ang_b),
                                   max_dist=64.0, ratio=0.85)
    np.testing.assert_array_equal(n(got.idx), n(want.idx))
    np.testing.assert_array_equal(n(got.valid), n(want.valid))
    plain = tmatch.match_descriptors(t(bits_a), t(bits_b), t(va), t(vb), max_dist=64.0,
                                     ratio=0.85)
    assert n(plain.valid).sum() > n(got.valid).sum() > 0   # the check removed some


def test_search_by_projection_angle_keywords():
    bits_a, bits_b, va, vb, ang_a, ang_b = _match_inputs(2)
    rng = np.random.default_rng(6)
    uv_b = rng.uniform(0, 300, (len(vb), 2)).astype(np.float32)
    uv_a = rng.uniform(0, 300, (len(va), 2)).astype(np.float32)
    oa = rng.integers(0, 3, len(va)).astype(np.int32)
    ob = rng.integers(0, 3, len(vb)).astype(np.int32)
    radius = np.full(len(va), 400.0, np.float32)
    for check in (True, False):
        want = jmatch.search_by_projection(
            jnp.asarray(uv_a), jnp.asarray(bits_a), jnp.asarray(va), jnp.asarray(oa),
            jnp.asarray(uv_b), jnp.asarray(bits_b), jnp.asarray(vb), jnp.asarray(ob),
            jnp.asarray(ang_b), jnp.asarray(ang_a), jnp.asarray(radius),
            max_dist=100.0, ratio=0.95, check_rotation=check)
        got = tmatch.search_by_projection(
            t(uv_a), t(bits_a), t(va), t(oa), t(uv_b), t(bits_b), t(vb), t(ob), t(radius),
            max_dist=100.0, ratio=0.95, kp_angles=t(ang_b), proj_angles=t(ang_a),
            check_rotation=check)
        np.testing.assert_array_equal(n(got.idx), n(want.idx))


def test_project_matches_reference():
    rng = np.random.default_rng(7)
    xc = np.concatenate([rng.uniform(-2, 2, (50, 2)), rng.uniform(-0.1, 5, (50, 1))], 1)
    xc = xc.astype(np.float32)
    intr = Intrinsics(525.0, 525.0, 319.5, 239.5)
    np.testing.assert_allclose(n(project(intr, t(xc))), n(j_project(JIntr(*intr), xc)),
                               rtol=1e-6, atol=1e-3)


# ---------------------------------------------------------------- Horn RANSAC
def _ransac_scene(seed, N=256, out_frac=0.3):
    rng = np.random.default_rng(seed)
    pa = rng.uniform(-2, 2, (N, 3)).astype(np.float32) + np.array([0, 0, 3], np.float32)
    T_true = jlie.se3_exp(jnp.array([0.3, -0.2, 0.5, 0.2, -0.1, 0.3]))
    pb = np.array(jlie.se3_apply(T_true, jnp.asarray(pa)))
    pb += rng.normal(0, 0.01, pb.shape)
    out = rng.choice(N, int(out_frac * N), replace=False)
    pb[out] += rng.uniform(0.5, 2.0, (len(out), 3))
    valid = rng.uniform(size=N) > 0.1
    return pa, pb.astype(np.float32), valid, np.asarray(T_true)


def _jax_draw(key, valid, n_hyp=256):
    logits = jnp.where(jnp.asarray(valid), 0.0, -jnp.inf)
    return n(jax.random.categorical(key, logits, shape=(n_hyp, 3)))


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_align_with_reference_draw(seed):
    pa, pb, valid, T_true = _ransac_scene(seed)
    key = jax.random.PRNGKey(seed + 3)
    want = jsim3.ransac_align(jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(valid), key)
    idx = _jax_draw(key, valid)
    got = tsim3.ransac_align(t(pa), t(pb), t(valid), torch.from_numpy(np.array(idx)))
    assert int(got.n_inliers) == int(want.n_inliers)
    np.testing.assert_array_equal(n(got.inliers), n(want.inliers))
    np.testing.assert_allclose(n(got.T_ba), n(want.T_ba), atol=1e-4)
    err = n(tlie.se3_log(tlie.se3_compose(got.T_ba, tlie.se3_inverse(t(T_true)))))
    assert np.linalg.norm(err) < 0.02


def test_horn_per_hypothesis_on_nondegenerate_triples():
    pa, pb, valid, _ = _ransac_scene(2)
    idx = _jax_draw(jax.random.PRNGKey(9), valid)
    distinct = (idx[:, 0] != idx[:, 1]) & (idx[:, 1] != idx[:, 2]) & (idx[:, 0] != idx[:, 2])
    idx = idx[distinct]
    assert len(idx) > 200
    jR, jt = jax.vmap(lambda i3: jsim3._horn(jnp.asarray(pa)[i3], jnp.asarray(pb)[i3],
                                             jnp.ones(3)))(jnp.asarray(idx))
    tR, tt = tsim3._horn(t(pa)[idx], t(pb)[idx], torch.ones(idx.shape))
    np.testing.assert_allclose(n(tR), n(jR), atol=1e-4)
    np.testing.assert_allclose(n(tt), n(jt), atol=1e-4)
    # weighted, over all rows
    w = (np.random.default_rng(3).uniform(size=len(pa)) > 0.4).astype(np.float32)
    jR1, jt1 = jsim3._horn(jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(w))
    tR1, tt1 = tsim3._horn(t(pa), t(pb), t(w))
    np.testing.assert_allclose(n(tR1), n(jR1), atol=1e-4)
    np.testing.assert_allclose(n(tt1), n(jt1), atol=1e-4)


def test_draw_hypotheses_valid_rows_only():
    valid = np.zeros(100, bool)
    valid[[3, 50, 77, 78]] = True
    a = tsim3.draw_hypotheses(valid, torch.Generator().manual_seed(17))
    b = tsim3.draw_hypotheses(valid, torch.Generator().manual_seed(17))
    assert a.shape == (256, 3) and set(a.unique().tolist()) == {3, 50, 77, 78}
    assert torch.equal(a, b)


# ---------------------------------------------------------------- Lie + pose graph
def _rand_poses(rng, k, rot=0.8, trans=1.0):
    xi = np.concatenate([rng.normal(0, trans, (k, 3)), rng.normal(0, rot, (k, 3))], 1)
    return np.array(jlie.se3_exp(jnp.asarray(xi.astype(np.float32))))


def test_so3_se3_log_match_reference():
    rng = np.random.default_rng(8)
    T = _rand_poses(rng, 64)
    T[0] = [1, 0, 0, 0, 0.1, 0.2, 0.3]                    # identity rotation
    T[1] = [-1, 0, 0, 0, 0, 0, 0]                          # w < 0
    T[2] = jlie.se3_exp(jnp.array([0.1, 0, 0, 1e-11, 0, 0]))  # small-angle branch
    np.testing.assert_allclose(n(tlie.so3_log(t(T[:, :4]))), n(jlie.so3_log(jnp.asarray(T[:, :4]))),
                               atol=1e-6)
    np.testing.assert_allclose(n(tlie.se3_log(t(T))), n(jlie.se3_log(jnp.asarray(T))), atol=1e-6)
    np.testing.assert_allclose(n(tlie.se3_apply(t(T), t(T[:, 4:7]))),
                               n(jlie.se3_apply(jnp.asarray(T), jnp.asarray(T[:, 4:7]))), atol=1e-6)


def _jax_edge_jac(Ti, Tj, Tm):
    z = jnp.zeros(6)

    def r_of(xi_i, xi_j, Ti_, Tj_, Tm_):
        return jpg._edge_residual(jlie.se3_retract(Ti_, xi_i), jlie.se3_retract(Tj_, xi_j), Tm_)

    f = jax.vmap(lambda a, b, c: (r_of(z, z, a, b, c),
                                  jax.jacfwd(r_of, argnums=0)(z, z, a, b, c),
                                  jax.jacfwd(r_of, argnums=1)(z, z, a, b, c)))
    return [n(x) for x in f(jnp.asarray(Ti), jnp.asarray(Tj), jnp.asarray(Tm))]


@pytest.mark.parametrize("residual", ["zero", "random"])
def test_pose_graph_edge_jacobians(residual):
    rng = np.random.default_rng(9)
    E = 48
    Ti, Tj = _rand_poses(rng, E), _rand_poses(rng, E)
    Ti[0] = Tj[0] = [1, 0, 0, 0, 0, 0, 0]               # identity poses
    from spslam_tpu.geometry import np_lie as jnp_lie
    Tm = jnp_lie.se3_compose(Ti, jnp_lie.se3_inverse(Tj))  # as loop_closer measures
    if residual == "random":
        Tm = n(jlie.se3_compose(jlie.se3_exp(jnp.asarray(
            rng.normal(0, 0.1, (E, 6)).astype(np.float32))), jnp.asarray(Tm)))
    je, jJi, jJj = _jax_edge_jac(Ti, Tj, Tm)
    prob = tpg.PoseGraphProblem(
        poses=t(np.concatenate([Ti, Tj])), fixed=None, valid=None,
        edge_i=torch.arange(E), edge_j=torch.arange(E, 2 * E), edge_T=t(Tm),
        edge_w=None, edge_valid=None)
    e, Ji, Jj = tpg.edge_terms(prob.poses, prob)
    for x in (e, Ji, Jj):
        assert torch.isfinite(x).all()
    np.testing.assert_allclose(n(e), je, atol=1e-5)
    np.testing.assert_allclose(n(Ji), jJi, atol=1e-5)
    np.testing.assert_allclose(n(Jj), jJj, atol=1e-5)
    if residual == "zero":
        assert np.abs(n(e)).max() < 1e-5


def _drifted_loop(K=32, seed=10):
    rng = np.random.default_rng(seed)
    T = jnp.array([1.0, 0, 0, 0, 0, 0, 0])
    step = jlie.se3_exp(jnp.array([0.2, 0.0, 0.0, 0.0, 2 * np.pi / K, 0.0]))
    true = []
    for _ in range(K):
        true.append(np.asarray(T))
        T = jlie.se3_compose(step, T)
    true = np.stack(true)
    drift = [true[0]]
    for i in range(1, K):
        rel = jlie.se3_compose(jnp.asarray(true[i]), jlie.se3_inverse(jnp.asarray(true[i - 1])))
        noise = jlie.se3_exp(jnp.asarray(rng.normal(0, 0.01, 6).astype(np.float32)))
        drift.append(np.asarray(jlie.se3_compose(jlie.se3_compose(noise, rel),
                                                 jnp.asarray(drift[-1]))))
    drift = np.stack(drift).astype(np.float32)
    ei, ej, eT, ew = [], [], [], []
    for i in range(1, K):
        eT.append(np.asarray(jlie.se3_compose(jnp.asarray(drift[i - 1]),
                                              jlie.se3_inverse(jnp.asarray(drift[i])))))
        ei.append(i - 1), ej.append(i), ew.append(1.0)
    eT.append(np.asarray(jlie.se3_compose(jnp.asarray(true[0]),
                                          jlie.se3_inverse(jnp.asarray(true[-1])))))
    ei.append(0), ej.append(K - 1), ew.append(5.0)
    # padded like the loop closer's 256-edge bucket, one invalid keyframe
    E, Ep = len(ei), 64
    pad = lambda a, fill: np.concatenate([np.asarray(a), np.full((Ep - E,) + np.asarray(a).shape[1:], fill)])  # noqa: E731
    eTp = np.concatenate([np.stack(eT), np.tile([1, 0, 0, 0, 0, 0, 0], (Ep - E, 1))]).astype(np.float32)
    poses = np.concatenate([drift, [[1, 0, 0, 0, 0, 0, 0]]]).astype(np.float32)
    return dict(
        poses=poses, fixed=np.array([True] + [False] * K), valid=np.array([True] * K + [False]),
        edge_i=pad(ei, 0).astype(np.int32), edge_j=pad(ej, 0).astype(np.int32), edge_T=eTp,
        edge_w=pad(ew, 0.0).astype(np.float32), edge_valid=np.arange(Ep) < E), true


def test_optimize_pose_graph_drifted_loop():
    arrs, true = _drifted_loop()
    want = n(jpg.optimize_pose_graph(jpg.PoseGraphProblem(
        **{k: jnp.asarray(v) for k, v in arrs.items()}), n_iters=20))
    got = n(tpg.optimize_pose_graph(tpg.PoseGraphProblem(
        **{k: t(v) for k, v in arrs.items()}), n_iters=20))
    np.testing.assert_allclose(got, want, atol=1e-4)
    K = len(true)
    before = np.linalg.norm(arrs["poses"][:K, 4:] - true[:, 4:], axis=1).mean()
    after = np.linalg.norm(got[:K, 4:] - true[:, 4:], axis=1).mean()
    assert after < 0.75 * before
    assert np.linalg.norm(got[K - 1, 4:] - true[-1, 4:]) < 0.05
    np.testing.assert_array_equal(got[K], arrs["poses"][K])   # invalid: untouched


# ---------------------------------------------------------------- global BA
@pytest.fixture(scope="module")
def scene():
    jst, poses_true, pts, pids = build_store_scene()
    return dict(jst=jst, poses_true=poses_true, pts=pts, pids=pids)


def test_build_point_obs_table_and_assembly(scene):
    obs_pt = np.array([0, 2, 2, 1, -1, 2, 0, 2], np.int32)
    np.testing.assert_array_equal(tba.build_point_obs_table(obs_pt, 4, 2),
                                  n(jba.build_point_obs_table(obs_pt, 4, 2)))
    # unsorted, padded, some points past the cap (exact)
    obs_pt = np.random.default_rng(5).integers(-1, 40, 600).astype(np.int32)
    np.testing.assert_array_equal(tba.build_point_obs_table(obs_pt, 48, 16),
                                  n(jba.build_point_obs_table(obs_pt, 48, 16)))
    jst = scene["jst"]
    st = port_store(jst)
    jst2 = JMapStore(JMapConfig(max_keyframes=32, max_points=4096, n_kp=256, max_obs_per_point=16))
    for k in list(SAVED_ARRAYS) + list(SAVED_COUNTS):
        setattr(jst2, k, np.array(getattr(jst, k)))
    for s in (st, jst2):
        s.erase_keyframe(3)
    jp, jk, jpt, jpl = jgba.assemble_global_problem(jst2, J_GBA_INTR)
    tp, tk, tpt, tpl = tgba.assemble_global_problem(st, GBA_INTR, device=DEV)
    for a, b in ((tk, jk), (tpt, jpt), (tpl, jpl)):
        np.testing.assert_array_equal(a, b)
    for name in jp._fields:
        np.testing.assert_array_equal(n(getattr(tp, name)), n(getattr(jp, name)), err_msg=name)
    assert 3 not in tk


def test_refine_alternating_matches_reference(scene):
    jst = scene["jst"]
    jp, _, _, _ = jgba.assemble_global_problem(jst, J_GBA_INTR)
    tp, _, _, _ = tgba.assemble_global_problem(port_store(jst), GBA_INTR, device=DEV)
    jpo, jpt = jba.refine_alternating(
        jp.poses, jp.pose_fixed | ~jp.pose_valid, jp.points, jp.point_valid, jp.obs_cam,
        jp.obs_pt, jp.obs_uv, jp.obs_ur, jp.obs_inv_sigma2, jp.obs_valid.astype(jnp.float32),
        J_GBA_INTR, n_iters=4)
    tpo, tpt = tba.refine_alternating(
        tp.poses, tp.pose_fixed | ~tp.pose_valid, tp.points, tp.point_valid, tp.obs_cam,
        tp.obs_pt, tp.obs_uv, tp.obs_ur, tp.obs_inv_sigma2, tp.obs_valid.to(torch.float32),
        GBA_INTR, n_iters=4)
    np.testing.assert_allclose(n(tpo), n(jpo), atol=1e-4)
    np.testing.assert_allclose(n(tpt), n(jpt), atol=1e-3)


def test_global_bundle_adjust_matches_reference(scene):
    jst = scene["jst"]
    st = port_store(jst)
    want = jgba.global_bundle_adjust(jst, J_GBA_INTR, write_back=False)
    assert tgba.global_bundle_adjust(st, GBA_INTR, device=DEV) is True
    np.testing.assert_allclose(st.kf_pose[want["kf_ids"]], want["poses"], atol=1e-4)
    np.testing.assert_allclose(st.pt_pos[want["pt_ids"]], want["points"], atol=1e-3)
    assert pose_err(st, scene["poses_true"]) < 2e-3
    np.testing.assert_array_equal(st.kf_pose[0], jst.kf_pose[0])   # gauge fixed
    scene["gba"] = want


def test_global_bundle_adjust_refuses_the_sharded_solver(scene):
    with pytest.raises(NotImplementedError, match="slice 4"):
        tgba.global_bundle_adjust(port_store(scene["jst"]), GBA_INTR, distributed=True,
                                  device=DEV)


# ---------------------------------------------------------------- detector gates
def _closers(consistency_needed=3):
    jintr = JIntr(fx=100.0, fy=100.0, cx=32.0, cy=24.0, bf=8.0, width=64, height=48)
    jst = JMapStore(JMapConfig(max_keyframes=32, max_points=512, n_kp=64))
    st = MapStore(MapConfig(max_keyframes=32, max_points=512, n_kp=64))
    return (JLoopCloser(jintr, jst, cfg=JLoopConfig(consistency_needed=consistency_needed)),
            LoopCloser(Intrinsics(*jintr), st,
                       cfg=LoopConfig(consistency_needed=consistency_needed), device=DEV))


CONSISTENCY_CASES = {
    "chain_of_3": (3, [[(0, {0, 1, 2})], [(1, {2, 3})], [(2, {3, 4})]]),
    "reset_on_gap": (3, [[(0, {0, 1})], [(1, {1, 2})], "reset", [(2, {2, 3})], [(3, {3, 4})],
                         [(4, {4, 5})]]),
    "disjoint": (2, [[(0, {0, 1})], [(5, {8, 9})]]),
    "parallel_chains": (3, [[(0, {0, 1}), (10, {10, 11})], [(1, {1, 2}), (11, {11, 12})],
                            [(2, {2, 3}), (12, {12, 13})]]),
    "near": (3, [[(0, {0, 1})], [(1, {1, 2})], [(2, {2, 3})]]),
}


@pytest.mark.parametrize("case", sorted(CONSISTENCY_CASES))
def test_consistency_check_matches_reference(case):
    needed, steps = CONSISTENCY_CASES[case]
    jlc, tlc = _closers(needed)
    outs = []
    for step in steps:
        if step == "reset":
            jlc._consistent, tlc._consistent = [], []
            continue
        want, got = jlc._consistency_check(step), tlc._consistency_check(step)
        assert got == want and tlc._consistent == jlc._consistent
        outs.append(got)
    accepted = {"chain_of_3": [2], "reset_on_gap": [4], "disjoint": [],
                "parallel_chains": [2, 12], "near": [2]}[case]
    assert sorted(outs[-1][0]) == accepted
    if case == "near":
        assert [o[1] for o in outs] == [[], [1], []]


def _covis_stores():
    """The reference's min-score-gate scene, in both packages."""
    jlc, tlc = _closers()
    rng = np.random.default_rng(0)
    n_kp = 64
    frames = [dict(uv=np.zeros((n_kp, 2), np.float32), octave=np.zeros(n_kp, np.int32),
                   angle=np.zeros(n_kp, np.float32),
                   desc=rng.integers(0, 2 ** 32, (n_kp, 8), dtype=np.uint32),
                   depth=np.ones(n_kp, np.float32), u_right=np.full(n_kp, -1.0, np.float32),
                   valid=np.ones(n_kp, bool)) for _ in range(6)]
    pos = rng.normal(size=(60, 3)).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (60, 8), dtype=np.uint32)
    for st in (jlc.store, tlc.store):
        for k in range(6):
            st.add_keyframe(np.array([1, 0, 0, 0, 0, 0, 0], np.float32), float(k), frames[k], k)
        pts = st.add_points_bulk(pos, desc, np.tile(np.array([0, 0, 1], np.float32), (60, 1)),
                                 np.ones(60, np.float32), ref_kf=4, slots=np.arange(60))
        st.add_observations_bulk(pts[:30], 0, np.arange(30))
        st.add_observations_bulk(pts[30:40], 3, np.arange(30, 40))
        st.add_observations_bulk(pts[40:], 5, np.arange(40, 60))
        st.add_observations_bulk(pts[:20], 1, np.arange(20))
    return jlc, tlc


def test_min_score_gate_covisibility_matches_reference():
    jlc, tlc = _covis_stores()
    for k in range(6):
        np.testing.assert_array_equal(tlc.store.covisibility(k, min_weight=5),
                                      jlc.store.covisibility(k, min_weight=5))
    covis = tlc.store.covisibility(4, min_weight=5)
    assert set(int(c) for c in covis) == {0, 1, 3, 5} and int(covis[0]) == 0


@pytest.mark.parametrize("cands", [
    [(0, 0.30), (1, 0.20), (3, 0.05), (5, 0.25)],
    [(3, 0.10), (2, 0.09)],
    [(5, 0.4), (4, 0.39), (0, 0.1), (2, 0.35)],
])
def test_acc_score_filter_matches_reference(cands):
    jlc, tlc = _covis_stores()
    assert tlc._acc_score_filter(cands) == jlc._acc_score_filter(cands)
    assert tlc._acc_score_filter([]) == []


# ---------------------------------------------------------------- async GBA
def _insert_child(store, parent, T_rel):
    from spslam_tpu_torch.geometry import np_lie

    n_kp = store.cfg.n_kp
    frame_np = dict(uv=np.zeros((n_kp, 2), np.float32), octave=np.zeros(n_kp, np.int32),
                    angle=np.zeros(n_kp, np.float32), desc=np.zeros((n_kp, 8), np.uint32),
                    depth=np.zeros(n_kp, np.float32), u_right=np.full(n_kp, -1.0, np.float32),
                    valid=np.zeros(n_kp, bool))
    T = np_lie.se3_compose(np.asarray(T_rel, np.float32), store.kf_pose[parent])
    with store.lock:
        return store.add_keyframe(T, 99.0, frame_np, 99, parent=parent), T


def test_merge_gba_matches_reference():
    jst, poses_true, _, _ = build_store_scene()
    st = port_store(jst)
    res = jgba.global_bundle_adjust(jst, J_GBA_INTR, write_back=False)
    T_rel = np.array([1, 0, 0, 0, 0.05, 0.0, 0.0], np.float32)
    for s in (jst, st):
        k, T_ins = _insert_child(s, 7, T_rel)
        with s.lock:
            s.add_points_bulk(np.array([[0.5, 0.5, 6.0]], np.float32), np.zeros((1, 8), np.uint32),
                              np.array([[0, 0, 1.0]], np.float32), np.array([6.0], np.float32),
                              k, np.array([0]))
    JLoopCloser(J_GBA_INTR, jst, cfg=JLoopConfig())._merge_gba(res)
    LoopCloser(GBA_INTR, st, cfg=LoopConfig(), device=DEV)._merge_gba(res)
    np.testing.assert_allclose(st.kf_pose[: st.n_kf], jst.kf_pose[: jst.n_kf], atol=1e-5)
    np.testing.assert_allclose(st.pt_pos[: st.n_pt], jst.pt_pos[: jst.n_pt], atol=1e-5)
    assert pose_err(st, poses_true) < 2e-3
    assert not np.allclose(st.kf_pose[k], T_ins, atol=1e-4)   # the child moved with its parent


def test_async_gba_does_not_stall_the_mapper(scene, monkeypatch):
    jst, poses_true = scene["jst"], scene["poses_true"]
    st = port_store(jst)
    lc = LoopCloser(GBA_INTR, st, cfg=LoopConfig(gba_async=True), device=DEV)
    real = tloop.global_bundle_adjust
    solved = threading.Event()

    def slow_gba(*a, **kw):
        out = real(*a, **kw)
        solved.set()
        time.sleep(0.6)
        return out

    monkeypatch.setattr(tloop, "global_bundle_adjust", slow_gba)
    lc._global_refine()
    assert lc._gba_future is not None and not lc._gba_future.done()
    assert solved.wait(180.0)
    t0 = time.perf_counter()
    new_kfs = [_insert_child(st, 7, [1, 0, 0, 0, 0.01 * (i + 1), 0, 0])[0] for i in range(5)]
    assert time.perf_counter() - t0 < 0.3
    assert not lc._gba_future.done()
    before = st.kf_pose[new_kfs[-1]].copy()
    assert lc.wait_gba() is True and lc._gba_future is None
    assert pose_err(st, poses_true) < 2e-3
    assert not np.allclose(st.kf_pose[new_kfs[-1]], before, atol=1e-6)
    assert lc.last_gba_ms > 0
    # the snapshot keyframes agree with the reference's solve of the same map
    want = scene.get("gba") or jgba.global_bundle_adjust(jst, J_GBA_INTR, write_back=False)
    np.testing.assert_allclose(st.kf_pose[want["kf_ids"]], want["poses"], atol=1e-4)


def test_wait_gba_clears_a_failed_worker(monkeypatch):
    st = MapStore(MapConfig(max_keyframes=8, max_points=64, n_kp=16))
    lc = LoopCloser(GBA_INTR, st, cfg=LoopConfig(gba_async=True), device=DEV)

    def boom(*a, **kw):
        raise RuntimeError("solver failed")

    monkeypatch.setattr(tloop, "global_bundle_adjust", boom)
    lc._global_refine()
    with pytest.raises(RuntimeError, match="solver failed"):
        lc.wait_gba()
    assert lc._gba_future is None
    assert lc.wait_gba() is True          # no stale re-raise
    # a closure after the failure is not blocked by it
    monkeypatch.setattr(tloop, "global_bundle_adjust", lambda *a, **kw: None)
    lc._global_refine()
    assert lc.wait_gba() is True


def test_jacobians_from_two_threads():
    """torch.func's forward-mode levels are process-global: the global BA's
    worker and the mapper's BA / the pose graph take their Jacobians under
    one lock (without it, concurrent jacfwd raises 'forward AD level').
    More threads than cores and a short switch interval."""
    arrs, _ = _drifted_loop()
    prob = tpg.PoseGraphProblem(**{k: t(v) for k, v in arrs.items()})
    want = tpg.edge_terms(prob.poses, prob)
    errors = []

    def work(k):
        try:
            for _ in range(8):
                if k % 2:
                    got = tpg.edge_terms(prob.poses, prob)
                    assert torch.equal(got[1], want[1])
                else:
                    tba.batched_jacfwd(lambda v: torch.sin(v) * v.sum(), 0, torch.randn(32, 6))
        except Exception as e:
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ths = [threading.Thread(target=work, args=(k,)) for k in range((os.cpu_count() or 4) + 2)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in ths)
    assert not errors, errors[:1]
