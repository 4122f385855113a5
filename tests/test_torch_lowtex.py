"""The low-texture claim of tests/integration/test_slam_lowtexture.py held
by the port alone on the CPU: on near-blank walls with 0.8% depth noise
(30 frames, seed 7, fed as the integration test feeds them: float gray and
float depth in meters), point-only tracking degrades and planes recover a
strictly better trajectory.

Bounds are the integration test's: point-only ATE > 10 mm, at least 4 map
planes, planes ATE < 0.8 x point-only ATE.
"""

import pytest

from spslam_tpu_torch.eval.ate import ate_rmse
from spslam_tpu_torch.io.synthetic import make_sequence
from spslam_tpu_torch.system import System, SystemConfig
from spslam_tpu_torch.tracking.tracker import TrackerConfig
from tests.test_torch_common import DEV


@pytest.fixture(scope="module")
def runs():
    seq = make_sequence(n_frames=30, low_texture=True, depth_noise=0.008, seed=7)
    out = {}
    for use_planes in (False, True):
        s = System(SystemConfig(intr=seq.intr, local_ba=True, use_planes=use_planes,
                                enable_reloc=False,
                                tracker=TrackerConfig(th_depth=3.2, pipeline_depth=2)),
                   device=DEV)
        for (gray, depth), ts in zip(seq.frames, seq.timestamps):
            s.track_rgbd(gray, depth, ts)
        s.shutdown()
        out[use_planes] = (ate_rmse(s.poses(), seq.poses_gt)[0], s)
    return out


def test_point_only_degrades_and_planes_rescue(runs):
    rmse_pt, s_pt = runs[False]
    rmse_pl, s_pl = runs[True]
    assert int(s_pt.store.pt_valid.sum()) < 900
    assert rmse_pt > 0.010, f"point-only should degrade: {rmse_pt}"
    assert int(s_pl.store.pl_valid.sum()) >= 4
    assert rmse_pl < 0.8 * rmse_pt, (rmse_pt, rmse_pl)


def test_lowtex_runs_never_lose_track(runs):
    for rmse, s in runs.values():
        assert not [m for m in s.tracker.metrics if m["state"] == "LOST"]
        assert s.store.n_kf >= 2 and rmse < 0.02
