"""Data-parallel evaluation in the port (spslam_tpu_torch/parallel/
dp_eval.py) on the CPU: tests/dist/test_dp_eval.py's four sequences
(seeds 0, 7, 14, 22; 8 frames), one System each on four "cpu" entries of
the device list.

Gates: each ATE < 20 mm (the reference test's); sequence 1's ATE in the
batch equals its solo run to 1e-6 (the Systems share nothing).
"""

import numpy as np
import pytest
import torch

from spslam_tpu_torch.io.synthetic import make_sequence
from spslam_tpu_torch.parallel.dp_eval import evaluate_sequences
from spslam_tpu_torch.system import System, SystemConfig


@pytest.fixture(scope="module")
def sequences():
    return [make_sequence(n_frames=8, seed=s) for s in (0, 7, 14, 22)]


@pytest.fixture(scope="module")
def batch(sequences):
    return evaluate_sequences(sequences, devices=["cpu"] * 4)


def test_dp_eval_four_sequences(batch):
    results, agg_fps = batch
    assert len(results) == 4 and agg_fps > 0
    for r in results:
        assert r.n_frames == 8 and r.n_kf >= 1
        assert r.device == "cpu" and r.states and "LOST" not in r.states
        assert r.ate_rmse_m < 0.02, f"{r.name}: ATE {r.ate_rmse_m}"
    assert len({r.wall_s for r in results}) == 1


def test_dp_matches_serial(sequences, batch):
    solo, _ = evaluate_sequences([sequences[1]], devices=[torch.device("cpu")])
    assert np.isclose(batch[0][1].ate_rmse_m, solo[0].ate_rmse_m, atol=1e-6), (
        batch[0][1].ate_rmse_m, solo[0].ate_rmse_m)


def test_dp_refuses_async_mapping(sequences):
    made = []

    def make(i, dev):
        made.append(System(SystemConfig(intr=sequences[i].intr, async_mapping=True,
                                        enable_reloc=False), device=dev))
        return made[-1]

    with pytest.raises(AssertionError, match="async_mapping=False"):
        evaluate_sequences(sequences[:1], make_system=make, devices=["cpu"])
    made[0].shutdown()
