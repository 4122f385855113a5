"""The loop-closure slice against spslam_tpu on the CPU: the reference's
64-frame loop sequence (tests/integration/test_slam_loop.py: a 1.25-turn
yaw in place, 0.4% depth noise) through System(use_loop=True,
local_ba=True) of both packages, fed u8 gray and u16 depth as bench.py
and chip_smoke.py feed them.

The port's LoopCloser and Tracker get the reference's RANSAC hypotheses:
their injectable draws replay the PRNGKey(17) and PRNGKey(23) key chains
of the JAX package (split, then `jax.random.categorical` over the valid
matches), so both packages verify each candidate against the same triples.

Both run their post-loop global BA inline (LoopConfig.gba_async=False),
so each run is deterministic at a fixed thread count: with the default
worker thread, when the solve's merge lands relative to the keyframes
inserted meanwhile depends on thread timing, and the ATE with it.  The
worker path is tested in tests/test_torch_loop.py and on the card.

Gate: both close >= 1 loop with ATE < 0.04 m (the integration test's
bound), and the port's ATE <= JAX's + 5 mm.  The lane is chaotic in float
order and thread timing, and the port's CPU runs are not bit-reproducible
(the BLAS's results depend on data alignment): on the CPU the port read
14.893 mm inline and 7.356-14.849 mm with the worker at 2 torch threads
(as tests/test_torch_common.py pins), 18.220 mm inline and 16.012 mm with
the worker at 8; JAX 15.124 mm inline, 16.051 mm with the worker
(`python -m tests.torch_cpu_runs loop64 [--gba-inline] [--threads N]`).
Later runs read 7.169, 14.750 (2 threads) and 7.673 mm (4 threads),
inline.  The ~15 mm readings, and JAX's, come from frames 51-52 sitting
~70 mm off; the 7 mm ones lack them.  On the card the port reads
28.9 mm, inline or with the worker, and closes at frame 48 as every CPU
run of both packages does (keyframe 45 there, as frames 31 and 33 made
no keyframe).  One frame makes it: frame 31 sits 213 mm off, and the other
frames read 11.3 mm.  That is outside this test's +5 mm gate, and no CPU
run has shown it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spslam_tpu.eval.ate import ate_rmse as j_ate
from spslam_tpu.geometry.camera import Intrinsics as JIntr
from spslam_tpu.system import System as JSystem, SystemConfig as JSystemConfig
from spslam_tpu_torch.eval.ate import ate_rmse as t_ate
from spslam_tpu_torch.io.synthetic import make_sequence
from spslam_tpu_torch.ops import fast_cuda
from spslam_tpu_torch.system import System, SystemConfig
from spslam_tpu_torch.tracking.tracker import TrackState
from tests.test_torch_common import DEV


def jax_draw_chain(seed: int):
    """The reference's hypothesis draws, one split of PRNGKey(seed) per
    RANSAC call, as a port draw function (valid [N] -> [256, 3])."""
    state = {"key": jax.random.PRNGKey(seed)}

    def draw(valid):
        state["key"], sub = jax.random.split(state["key"])
        logits = jnp.where(jnp.asarray(valid), 0.0, -jnp.inf)
        return torch.from_numpy(np.array(jax.random.categorical(sub, logits, shape=(256, 3))))

    return draw


def u8_u16(frames):
    return [(np.clip(g, 0, 255).astype(np.uint8),
             np.clip(d * 5000.0, 0, 65535).astype(np.uint16)) for g, d in frames]


@pytest.fixture(scope="module")
def seq():
    s = make_sequence(n_frames=64, trajectory="loop", depth_noise=0.004)
    s.frames = u8_u16(s.frames)
    return s


@pytest.fixture(scope="module")
def runs(seq):
    jsys = JSystem(JSystemConfig(intr=JIntr(*seq.intr), local_ba=True, use_loop=True))
    tsys = System(SystemConfig(intr=seq.intr, local_ba=True, use_loop=True), device=DEV)
    tsys.loop_closer.draw = jax_draw_chain(17)
    tsys.tracker.reloc_draw = jax_draw_chain(23)
    for s in (jsys, tsys):
        s.loop_closer.cfg = dataclasses.replace(s.loop_closer.cfg, gba_async=False)
    launches0 = fast_cuda.LAUNCHES
    for (gray, depth), ts in zip(seq.frames, seq.timestamps):
        jsys.track_rgbd(gray, depth, ts)
        tsys.track_rgbd(gray, depth, ts)
    jsys.shutdown()
    tsys.shutdown()
    return dict(jsys=jsys, tsys=tsys, launches=fast_cuda.LAUNCHES - launches0)


def test_loop_sequence_matches_reference(seq):
    from spslam_tpu.io import synthetic as jsyn

    np.testing.assert_allclose(seq.poses_gt, jsyn.loop_trajectory(64), rtol=0, atol=1e-6)
    jg, jd = jsyn.render_frame(jsyn.make_room(seed=0), seq.poses_gt[40], JIntr(*seq.intr))
    g, _ = seq.frames[40]
    assert np.mean(g != np.clip(jg, 0, 255).astype(np.uint8)) < 1e-4


def test_loop_closes_against_reference(seq, runs):
    jsys, tsys = runs["jsys"], runs["tsys"]
    assert tsys.tracker.pipeline_depth == 2 and tsys.loop_closer.vocab.trained
    assert jsys.loop_closer.n_loops_closed >= 1 and tsys.loop_closer.n_loops_closed >= 1
    ate_j, _ = j_ate(jsys.poses(), seq.poses_gt)
    ate_t, _ = t_ate(tsys.poses(), seq.poses_gt)
    assert ate_j < 0.04 and ate_t < 0.04, (ate_j, ate_t)
    assert ate_t <= ate_j + 5e-3, (ate_t, ate_j)
    lost_j = sum(1 for m in jsys.tracker.metrics if m["state"] == "LOST")
    lost_t = sum(1 for m in tsys.tracker.metrics if m["state"] == "LOST")
    assert lost_t <= lost_j and tsys.tracker.state == TrackState.OK


def test_loop_run_bookkeeping(runs, tmp_path):
    tsys = runs["tsys"]
    lc, st = tsys.loop_closer, tsys.store
    assert runs["launches"] == 0                         # the CPU never launches B1
    closed = [e for e in lc.events if e["kind"] == "closed"]
    assert len(closed) == lc.n_loops_closed and len(lc.loop_edges) >= lc.n_loops_closed
    c = closed[0]
    assert c["inliers"] >= 20 and c["kf"] - c["cand"] >= 10 and c["pose_graph_ms"] > 0
    assert lc._gba_future is None and lc.last_gba_ms > 0
    assert [e["kind"] for e in lc.events].count("gba") == lc.n_loops_closed + 1   # + shutdown
    # every valid keyframe is indexed for relocalization
    assert set(np.nonzero(st.kf_valid[: st.n_kf])[0]) <= set(lc.kfdb.bow)
    path = tmp_path / "kf.txt"
    tsys.save_keyframe_trajectory_tum(str(path))
    assert len(path.read_text().splitlines()) == int(st.kf_valid.sum())


def test_no_false_loops_on_short_sequence():
    s = make_sequence(n_frames=10)
    sys_ = System(SystemConfig(intr=s.intr, local_ba=False, use_loop=True), device=DEV)
    for (gray, depth), ts in zip(s.frames, s.timestamps):
        sys_.track_rgbd(gray, depth, ts)
    sys_.shutdown()
    assert sys_.loop_closer.n_loops_closed == 0
    assert sys_.tracker.state == TrackState.OK
