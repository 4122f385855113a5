"""One fused tracking step of the port (tracking/tracker.track_frame_step)
against spslam_tpu's on the same map snapshot and frame, on the CPU.

Tolerances: pose within 1e-4 (three LM stages of float32 sums in another
order); the packed buffers decode identically through the numpy
unpackers, except for keypoints whose orientation lands on the other side
of a quantization boundary (30 steering bins for the descriptor, 256 bins
in the keyframe bundle): at most 1% of the keypoints, and the match table
and inlier counts may differ by as many rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spslam_tpu.geometry.camera import Intrinsics as JIntr
from spslam_tpu.map.store import MapConfig as JMapConfig, MapStore as JMapStore
from spslam_tpu.tracking import tracker as jtr
from spslam_tpu_torch.geometry import np_lie
from spslam_tpu_torch.tracking import tracker as ttr
from tests.test_torch_common import n, t


@pytest.fixture(scope="module")
def scene():
    from spslam_tpu_torch.io.synthetic import make_sequence

    seq = make_sequence(n_frames=3)
    frames = [(np.clip(g, 0, 255).astype(np.uint8),
               np.clip(d * 5000.0, 0, 65535).astype(np.uint16)) for g, d in seq.frames]
    cfg = jtr.TrackerConfig()
    jt = jtr.Tracker(cfg, JIntr(*seq.intr), JMapStore(JMapConfig()))
    jt.process(*frames[0], 0.0)            # initialize the map on frame 0
    assert jt.state == jtr.TrackState.OK
    ids, pack, desc, pl_pack = jt._local_snapshot()
    gray, depth = frames[2]
    depth2 = np.ascontiguousarray(depth[::2, ::2])
    return dict(seq=seq, cfg=cfg, jt=jt, pack=np.asarray(pack), desc=np.asarray(desc),
                pl_pack=pl_pack, gray=gray, depth2=depth2)


def _steps(sc, T_prev):
    cfg, intr = sc["cfg"], sc["seq"].intr
    jspec = sc["jt"].spec
    _, jsmall, jbig = jtr.track_frame_step(
        jnp.asarray(sc["gray"]), jnp.asarray(sc["depth2"]), jnp.asarray(T_prev),
        jnp.asarray(T_prev), jnp.asarray(False), jnp.asarray(sc["pack"]),
        jnp.asarray(sc["desc"]), sc["pl_pack"], cfg.motion_search_radius,
        cfg.local_search_radius, cfg.th_depth, jspec, JIntr(*intr), cfg.n_features,
        cfg.th_fast_high, cfg.th_fast_low,
    )
    tspec = ttr.PyramidSpec(*jspec)
    _, tsmall, tbig = ttr.track_frame_step(
        t(sc["gray"]), t(sc["depth2"].view(np.int16)), t(T_prev), t(T_prev),
        torch.tensor(False), t(sc["pack"]), t(sc["desc"]), cfg.motion_search_radius,
        cfg.local_search_radius, cfg.th_depth, tspec, intr, cfg.n_features,
        cfg.th_fast_high, cfg.th_fast_low,
    )
    return (np.asarray(jsmall), np.asarray(jbig),
            n(tsmall).view(np.uint32), n(tbig).view(np.uint32))


@pytest.mark.parametrize("prior", ["good", "garbage"])
def test_track_frame_step_parity(scene, prior):
    cfg, intr = scene["cfg"], scene["seq"].intr
    # the map frame is camera 0's frame: the true pose of frame 2 in it
    gt = scene["seq"].poses_gt
    T_prev = np_lie.se3_compose(gt[2], np_lie.se3_inverse(gt[0]))
    if prior == "garbage":
        T_prev[4:7] = [5.0, 0.0, 0.0]      # the motion window misses: fallback fires
    js, jb, ts_, tb = _steps(scene, T_prev)
    assert ts_.dtype == js.dtype and ts_.shape == js.shape and tb.shape == jb.shape
    jscal, jmp = ttr.unpack_track_small(js, cfg.local_points_cap)
    tscal, tmp = ttr.unpack_track_small(ts_, cfg.local_points_cap)
    np.testing.assert_allclose(tscal[:7], jscal[:7], rtol=0, atol=1e-4)
    n_kp = cfg.n_features
    slack = int(0.01 * n_kp)
    np.testing.assert_allclose(tscal[7:11], jscal[7:11], rtol=0, atol=slack)
    if prior == "garbage":
        assert jscal[11] >= 0 and tscal[11] >= 0
        assert abs(tscal[11] - jscal[11]) <= slack
    else:
        assert jscal[11] == -1 and tscal[11] == -1
    assert jscal[8] > 50
    assert np.sum(tmp != jmp) <= slack

    jf = jtr.unpack_track_big(jb, n_kp, JIntr(*intr), 5000.0)
    tf = ttr.unpack_track_big(tb, n_kp, intr, 5000.0)
    for k in ("uv", "octave", "depth", "u_right", "valid", "xyz_cam"):
        np.testing.assert_array_equal(tf[k], jf[k], err_msg=k)
    same = np.all(tf["desc"] == jf["desc"], axis=1) & (tf["angle"] == jf["angle"])
    assert np.mean(~same) <= 0.01
    assert tf["desc"].dtype == np.uint32


def test_layout_guards():
    with pytest.raises(ValueError):
        ttr.unpack_track_small(np.zeros(10, np.uint32), 4096)
    with pytest.raises(ValueError):
        ttr.unpack_track_big(np.zeros(10, np.uint32), 1024, ttr.Intrinsics(1, 1, 0, 0), 5000.0)


def test_decode_depth_u16_bits():
    raw = np.array([[0, 1, 32767, 32768, 65535]], np.uint16)
    got = n(ttr.decode_depth(t(raw.view(np.int16)), 5000.0))
    np.testing.assert_array_equal(got, raw.astype(np.float32) / np.float32(5000.0))
