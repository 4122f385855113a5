"""The check catches a broken timed path.

Each test skips the harness's look for a card and drives the rest of a
run (render, window, flush, reference check) on the CPU at a small size,
with the program's fused step broken underneath, and sees `correct` come
out false; the sound run beside them sees it true.  (One card: no
exchange between chips to leave out.)
"""

import functools

import pytest
import torch

from benchmark import run, spec
from spslam_tpu_torch.tracking import tracker


def _tiny(name):
    c = spec.cell(name)
    return c._replace(traffic=dict(c.traffic, frames_per_session=4,
                                   room_seeds=c.traffic["room_seeds"][:1]),
                      limits=dict(c.limits, check_steps=2, min_steps=1))


def _run(name, seed=2**31 + 17):
    torch.set_num_threads(2)
    return run.execute(_tiny(name), seed, 5.0, False, torch.device("cpu"), warm=False)


def _state_unchanged(step):
    """The step returns the pose it started from."""
    @functools.wraps(step)
    def broken(frame_gray, frame_depth, T_prev, *a, **kw):
        frame, small, big = step(frame_gray, frame_depth, T_prev, *a, **kw)
        small = small.clone()
        small[:7] = T_prev.view(torch.int32)
        return frame, small, big
    return broken


def _answer_altered(step):
    """The pose moves 5 mm along x where the step produces it."""
    @functools.wraps(step)
    def broken(*a, **kw):
        frame, small, big = step(*a, **kw)
        small = small.clone()
        small[4:5] = (small[4:5].view(torch.float32) + 0.005).view(torch.int32)
        return frame, small, big
    return broken


def _half_left_out(build):
    """The frame keeps only the first half of its keypoints."""
    @functools.wraps(build)
    def broken(*a, **kw):
        f = build(*a, **kw)
        keep = torch.arange(f.valid.shape[0]) < f.valid.shape[0] // 2
        return f._replace(valid=f.valid & keep, has_depth=f.has_depth & keep)
    return broken


@pytest.mark.parametrize("name", ["orbslam2_tum3.orbit", "spslam_tum3.lowtex"])
def test_sound_run_is_correct(name):
    out = _run(name)
    assert out["correct"], out["checks"]
    assert out["checks"]["feature_mismatch"]["value"] == 0.0


@pytest.mark.parametrize("name", ["orbslam2_tum3.orbit", "spslam_tum3.lowtex"])
@pytest.mark.parametrize("fault,attr", [(_state_unchanged, "track_frame_step"),
                                        (_answer_altered, "track_frame_step"),
                                        (_half_left_out, "build_frame")])
def test_broken_step_is_not_correct(monkeypatch, name, fault, attr):
    monkeypatch.setattr(tracker, attr, fault(getattr(tracker, attr)))
    out = _run(name)
    assert not out["correct"], out["checks"]


def test_traced_run_reads_the_host_layers():
    """A --trace 1 run on the CPU: the host layers' readers find their
    sections and spans, the device's find nothing and stay out."""
    torch.set_num_threads(2)
    out = run.execute(_tiny("spslam_tum3.lowtex"), 2**31 + 29, 6.0, True,
                      torch.device("cpu"), warm=False)
    got = out["metrics"]
    assert {"tracker.dispatch_ms", "mapper.ms_per_keyframe", "loop.ms_per_keyframe"} <= set(got)
    assert not {"device.idle_pct", "device.kernels_per_frame", "fast_nms_roofline",
                "tracker.resolve_ms"} & set(got)     # the last: not a metric of this cell
    assert all(v["value"] > 0 for v in got.values())
    assert out["correct"] and list(out)[-1] == "checks"
