"""The port's dp_eval_bench (spslam_tpu_torch/tools/dp_eval_bench.py) on
the CPU at 2 sequences x 6 frames: its JSON line carries the reference
tool's keys (tools/dp_eval_bench.py) and positive frame rates."""

import json

from spslam_tpu_torch.tools import dp_eval_bench
from tests import test_torch_common  # noqa: F401  (pins the torch threads)


def test_dp_eval_bench_prints_reference_keys(capsys):
    assert dp_eval_bench.main(["--device", "cpu", "--sequences", "2", "--frames", "6"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"metric", "value", "unit", "serial_fps", "aggregate_fps", "sequences",
                        "devices"}
    assert out["metric"] == "dp_eval_speedup" and out["sequences"] == 2 and out["devices"] == 1
    assert out["unit"] == "aggregate_fps_over_serial_fps"
    assert out["serial_fps"] > 0 and out["aggregate_fps"] > 0 and out["value"] > 0
