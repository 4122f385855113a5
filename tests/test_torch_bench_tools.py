"""The port's measurement entry points (spslam_tpu_torch/bench.py and
spslam_tpu_torch/tools/) against the repo's bench.py and tools/ on the CPU.

Tolerances, each where it is checked:
* `quantized`: equal to the reference bench's formula exactly;
* the render cache: the port's file never the reference's for the same
  render kwargs; an unreadable file is rendered again;
* the bench's point lane at 12 frames, one pass, `--device cpu`: one JSON
  line with the reference's point-lane keys, ATE < 20 mm (the integration
  test's bound);
* every entry point raises RuntimeError without CUDA unless the CPU is
  asked for;
* weak scaling: `make_problem`'s integer arrays equal, its float arrays
  within 1e-5 of each array's largest magnitude (float32 geometry on both
  sides; u = fx x / z + cx near 0 carries one float32 ulp of cx = 319.5,
  3.1e-5, so an absolute 1e-5 would ask for bit equality), the D in
  {1, 2} sweep's JSON line with the reference's keys;
* vocab_recall: `true_revisits` and `evaluate` equal to the reference's
  exactly on the same descriptors, poses and vocabulary arrays (both read
  the committed vocabulary).
"""

import hashlib
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from spslam_tpu_torch import bench
from spslam_tpu_torch.tools import dp_eval_bench, profile_host, vocab_recall, weak_scaling
from tests import test_torch_common  # noqa: F401  (pins the torch threads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(ROOT, "data", "vocab_synth.npz")
POINT_KEYS = {"metric", "value", "unit", "vs_baseline", "ate_rmse_m", "point_passes"}
JSON_KEYS_WEAK = {"metric", "value", "unit", "devices", "weak_scaling_efficiency_estimate",
                  "ba_iters_per_sec_1dev"}


def _ref_tool(name):
    spec = importlib.util.spec_from_file_location(f"ref_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_quantized_matches_reference_formula():
    rng = np.random.default_rng(0)
    frames = [(rng.uniform(-20, 280, (48, 64)).astype(np.float32),
               rng.uniform(-0.5, 14.0, (48, 64)).astype(np.float32)) for _ in range(3)]
    got = bench.quantized(frames)
    for (g, d), (gq, dq) in zip(frames, got):
        np.testing.assert_array_equal(gq, np.clip(g, 0, 255).astype(np.uint8))
        np.testing.assert_array_equal(dq, np.clip(d * 5000.0, 0, 65535).astype(np.uint16))
        assert gq.dtype == np.uint8 and dq.dtype == np.uint16


def _ref_cache_path(tag, **kw):
    """The reference bench's cache file name for `tag` and the kwargs."""
    kw_key = hashlib.sha1(
        json.dumps({k: str(v) for k, v in sorted(kw.items())}).encode()).hexdigest()[:8]
    return os.path.join(ROOT, "data", f".bench_cache_{tag}_{kw_key}.npz")


LANE_RENDERS = [
    ("orbit40", "torch_orbit40", dict(n_frames=40)),
    ("lowtex30", "torch_lowtex30", dict(n_frames=30, low_texture=True, depth_noise=0.008,
                                        seed=7)),
    ("loop128", "torch_loop128", dict(n_frames=128, trajectory="loop", depth_noise=0.004)),
]


def test_cache_path_never_the_reference_file():
    ref = {_ref_cache_path(t, **kw) for t, _, kw in LANE_RENDERS}
    ours = {bench.cache_path(t, **kw) for _, t, kw in LANE_RENDERS}
    assert len(ours) == 3 and not ours & ref
    for p in ours:
        assert os.path.dirname(p) == os.path.join(ROOT, "data")
        assert os.path.basename(p).startswith(".bench_cache_torch_") and p.endswith(".npz")


def test_unreadable_cache_is_rendered_again(tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "DATA_DIR", str(tmp_path))
    kw = dict(n_frames=2, seed=3)
    path = bench.cache_path("t2", **kw)
    with open(path, "wb") as f:
        f.write(b"not an npz")
    seq = bench.cached_sequence("t2", **kw)
    again = bench.cached_sequence("t2", **kw)      # now read from the file
    assert len(seq.frames) == len(again.frames) == 2
    for (g, d), (g2, d2) in zip(seq.frames, again.frames):
        assert g.dtype == np.uint8 and d.dtype == np.uint16
        np.testing.assert_array_equal(g, g2)
        np.testing.assert_array_equal(d, d2)


def test_bench_point_lane_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(bench, "DATA_DIR", str(tmp_path))
    for k, v in dict(BENCH_FRAMES="12", BENCH_PASSES="1", BENCH_PLANES="0", BENCH_LOWTEX="0",
                     BENCH_LOOP="0").items():
        monkeypatch.setenv(k, v)
    assert bench.main(["--device", "cpu"]) == 0
    lines = [x for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == POINT_KEYS
    assert out["metric"] == "tracking_fps" and out["unit"] == "frames/sec"
    assert out["vs_baseline"] == round(out["value"] / 30.0, 3)
    assert len(out["point_passes"]) == 1 and set(out["point_passes"][0]) == {"ms", "ate_mm"}
    assert 0 < out["ate_rmse_m"] < 0.02


@pytest.mark.parametrize("entry", ["bench", "profile_host", "weak_scaling", "dp_eval_bench",
                                   "vocab_recall"])
def test_default_device_without_cuda_raises(entry):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    main = {"bench": bench.main, "profile_host": profile_host.main,
            "weak_scaling": weak_scaling.main, "dp_eval_bench": dp_eval_bench.main,
            "vocab_recall": vocab_recall.main}[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([])


def _ref_make_problem(n_pts, n_cams=64):
    """tools/weak_scaling.py's make_problem (nested in its main there)."""
    from spslam_tpu.geometry import Intrinsics, project, se3_apply, se3_exp

    intr = Intrinsics(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0)
    rng = np.random.default_rng(0)
    poses = np.stack([
        np.asarray(se3_exp(jnp.array([0.05 * i, 0, 0, 0, 0.01 * i, 0], np.float32)))
        for i in range(n_cams)
    ])
    pts = np.stack([
        rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts), rng.uniform(3, 9, n_pts)
    ], -1).astype(np.float32)
    obs_cam = rng.integers(0, n_cams, n_pts * 4).astype(np.int32)
    obs_pt = np.repeat(np.arange(n_pts, dtype=np.int32), 4)
    xc = np.asarray(se3_apply(jnp.asarray(poses[obs_cam]), jnp.asarray(pts[obs_pt])))
    uv = np.array(project(intr, jnp.asarray(xc)))
    ur = uv[:, 0] - intr.bf / np.maximum(xc[:, 2], 0.1)
    ok = (xc[:, 2] > 0.2) & (uv[:, 0] > -1e4) & (uv[:, 0] < 1e4)
    fixed = np.zeros(n_cams, bool)
    fixed[0] = True
    return (poses, fixed, pts, obs_cam[ok], obs_pt[ok],
            uv[ok].astype(np.float32), ur[ok].astype(np.float32))


def test_weak_scaling_problem_matches_reference():
    got = weak_scaling.make_problem(2048)
    want = _ref_make_problem(2048)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())
        else:
            np.testing.assert_array_equal(g, w)


def test_weak_scaling_sweep_prints_reference_keys(capsys):
    assert weak_scaling.main(["--device", "cpu", "--devices", "2", "--points-per-shard", "128",
                              "--cams", "8", "--iters", "2"]) == 0
    out = capsys.readouterr().out
    summary = _last_json(out)
    assert set(summary) == JSON_KEYS_WEAK
    assert summary["metric"] == "dist_ba_comm_overhead_frac" and summary["devices"] == 2
    assert "D=1:" in out and "D=2:" in out and "caveat:" in out


def _eval_set(rng):
    """A 1.25-turn loop of 24 pseudo-keyframes: a keyframe's descriptors
    are drawn from the pool of its yaw bin (revisits share words) plus
    rows of its own."""
    from spslam_tpu_torch.io.synthetic import loop_trajectory

    poses = loop_trajectory(96)[::vocab_recall.KF_STRIDE]
    bins = rng.integers(0, 2 ** 32, (12, 200, 8), dtype=np.uint32)
    kfs = []
    for i, T in enumerate(poses):
        b = bins[(i * 12 * 5 // (4 * len(poses))) % 12]
        own = rng.integers(0, 2 ** 32, (40, 8), dtype=np.uint32)
        kfs.append(dict(desc=np.concatenate([b[rng.choice(200, 120, replace=False)], own]),
                        T=T))
    return [dict(tag="loop", kfs=kfs)]


def test_vocab_recall_matches_reference():
    from spslam_tpu.loop.vocab import Vocabulary as JVocabulary
    from spslam_tpu_torch.loop.vocab import Vocabulary

    ref = _ref_tool("vocab_recall")
    eval_set = _eval_set(np.random.default_rng(1))
    kfs = eval_set[0]["kfs"]
    want_rv = ref.true_revisits(kfs)
    assert vocab_recall.true_revisits(kfs) == want_rv
    assert sum(bool(v) for v in want_rv.values()) >= 3
    jv = JVocabulary(n_words=4096)
    jv.load(VOCAB)
    tv = Vocabulary(n_words=4096, device="cpu")
    tv.load(VOCAB)
    floors = [0.005, 0.010, 0.015, 0.030, 0.050]
    want = ref.evaluate(jv, eval_set, floors)
    assert vocab_recall.evaluate(tv, eval_set, floors) == want
    assert want[0.005][2] >= 3 and want[0.005][0] > 0
