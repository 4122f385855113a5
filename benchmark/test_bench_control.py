"""The control on the card: the plain reference computed in TF32 (the
nearest precision below the configurations' float32 with TF32 off), put in
the program's place, fails the cell's check, while the program passes it.
At the cell's own sizes, on three seeds, with a short window.

    python -m pytest benchmark/test_bench_control.py -m cuda
"""

import pytest

from benchmark import check, readings, spec


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["orbslam2_tum3.orbit", "spslam_tum3.lowtex"])
def test_control_fails_and_program_passes(cuda_device, name):
    cell = spec.cell(name)
    rows = readings.collect(cell, [2**31 + 101, 2**31 + 202, 2**31 + 303], 3, 16.0, cuda_device)
    for r in rows:
        prog, ctrl = (check.Readings(*(r[k][f] for f in check.Readings._fields))
                      for k in ("program", "control"))
        assert check.verdict(prog, cell.limits)[0], r
        assert not check.verdict(ctrl, cell.limits)[0], r
