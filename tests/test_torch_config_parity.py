"""The port's dataclasses against spslam_tpu's, and the loop closer's
first-sight closure against the reference's, on the CPU.

* Every dataclass of the reference has a counterpart of the same name in
  the same module of the port, with the same field names in the same
  order and the same defaults (a default factory is called on both sides;
  arrays compare by value, nested dataclasses field by field), exactly.
* `LoopConfig.first_sight_inlier_scale`: the same keyframe database
  contents and candidates through both packages' `process_keyframe`, with
  `_close_loop` replaced by a recorder, give the same calls (keyframe,
  candidate, inlier scale) in the same order and the same `closed` event;
  at the default 0.0 no first-sight call is made.
"""

import dataclasses
import importlib
import os

import numpy as np
import pytest

from spslam_tpu.loop.loop_closer import LoopCloser as JLoopCloser, LoopConfig as JLoopConfig
from spslam_tpu.loop.kfdb import KeyFrameDatabase as JKFDB
from spslam_tpu.loop.vocab import Vocabulary as JVocabulary
from spslam_tpu.geometry.camera import Intrinsics as JIntr
from spslam_tpu.map.store import MapConfig as JMapConfig, MapStore as JMapStore
from spslam_tpu_torch.geometry.camera import Intrinsics
from spslam_tpu_torch.loop.kfdb import KeyFrameDatabase
from spslam_tpu_torch.loop.loop_closer import LoopCloser, LoopConfig
from spslam_tpu_torch.loop.vocab import Vocabulary
from spslam_tpu_torch.map.store import MapConfig, MapStore
from tests.test_torch_common import DEV

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(ROOT, "data", "vocab_synth.npz")

DATACLASSES = [
    ("system", "SystemConfig"),
    ("tracking.tracker", "TrackerConfig"),
    ("tracking.tracker", "FrameRecord"),
    ("map.store", "MapConfig"),
    ("mapping.local_mapper", "MapperConfig"),
    ("mapping.plane_mapper", "PlaneMapperConfig"),
    ("loop.loop_closer", "LoopConfig"),
    ("parallel.dp_eval", "SeqResult"),
    ("io.synthetic", "TexturedRect"),
    ("io.synthetic", "SyntheticSequence"),
    ("io.tum", "TumSequence"),
]


def test_every_reference_dataclass_is_listed():
    import ast

    found = set()
    for dirpath, _, files in os.walk(os.path.join(ROOT, "spslam_tpu")):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            mod = os.path.relpath(path, os.path.join(ROOT, "spslam_tpu"))[:-3].replace(os.sep, ".")
            for node in ast.parse(open(path).read()).body:
                if isinstance(node, ast.ClassDef) and any(
                        "dataclass" in ast.dump(d) for d in node.decorator_list):
                    found.add((mod, node.name))
    assert found == set(DATACLASSES)


def _default(f):
    if f.default is not dataclasses.MISSING:
        return f.default
    if f.default_factory is not dataclasses.MISSING:
        return f.default_factory()
    return dataclasses.MISSING


def _same(a, b, where):
    """Equal by value: dataclasses field by field, arrays elementwise,
    tuples (NamedTuples too) item by item."""
    if dataclasses.is_dataclass(a) or dataclasses.is_dataclass(b):
        assert type(a).__name__ == type(b).__name__, where
        _same_fields(type(a), type(b), where, a, b)
    elif hasattr(a, "shape") or hasattr(b, "shape"):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=where)
    elif isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b), where
        assert getattr(a, "_fields", None) == getattr(b, "_fields", None), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b and type(a) is type(b), f"{where}: {a!r} != {b!r}"


def _same_fields(ref_cls, port_cls, where, ref_obj=None, port_obj=None):
    rf, pf = dataclasses.fields(ref_cls), dataclasses.fields(port_cls)
    assert [f.name for f in pf] == [f.name for f in rf], where
    for r, p in zip(rf, pf):
        if ref_obj is None:
            _same(_default(r), _default(p), f"{where}.{r.name}")
        else:
            _same(getattr(ref_obj, r.name), getattr(port_obj, r.name), f"{where}.{r.name}")


@pytest.mark.parametrize("mod,name", DATACLASSES, ids=[n for _, n in DATACLASSES])
def test_dataclass_fields_and_defaults_match_reference(mod, name):
    ref = getattr(importlib.import_module(f"spslam_tpu.{mod}"), name)
    port = getattr(importlib.import_module(f"spslam_tpu_torch.{mod}"), name)
    assert dataclasses.is_dataclass(port)
    _same_fields(ref, port, name)


# ---------------------------------------------------------------- first sight
N_KF, N_KP = 16, 64


def _closer_pair(scale):
    """Both packages' LoopCloser on the same 16-keyframe store and the
    committed vocabulary; keyframes 0..14 indexed, keyframe 15's
    descriptors are 36 rows of keyframe 2's and 28 of keyframe 3's (two
    candidates, keyframe 2 the top one)."""
    rng = np.random.default_rng(5)
    descs = rng.integers(0, 2 ** 32, (N_KF, N_KP, 8), dtype=np.uint32)
    descs[15, :36] = descs[2, :36]
    descs[15, 36:] = descs[3, 36:]
    jintr = JIntr(fx=100.0, fy=100.0, cx=32.0, cy=24.0, bf=8.0, width=64, height=48)
    jst = JMapStore(JMapConfig(max_keyframes=32, max_points=512, n_kp=N_KP))
    st = MapStore(MapConfig(max_keyframes=32, max_points=512, n_kp=N_KP))
    jvoc = JVocabulary(n_words=4096)
    jvoc.load(VOCAB)
    voc = Vocabulary(n_words=4096, device=DEV)
    voc.load(VOCAB)
    jlc = JLoopCloser(jintr, jst, vocab=jvoc, cfg=JLoopConfig(first_sight_inlier_scale=scale))
    tlc = LoopCloser(Intrinsics(*jintr), st, vocab=voc,
                     cfg=LoopConfig(first_sight_inlier_scale=scale), device=DEV)
    jlc.kfdb, tlc.kfdb = JKFDB(use_native=False), KeyFrameDatabase(use_native=False)
    for lc in (jlc, tlc):
        for k in range(N_KF):
            frame = dict(uv=np.zeros((N_KP, 2), np.float32), octave=np.zeros(N_KP, np.int32),
                         angle=np.zeros(N_KP, np.float32), desc=descs[k],
                         depth=np.ones(N_KP, np.float32),
                         u_right=np.full(N_KP, -1.0, np.float32), valid=np.ones(N_KP, bool))
            lc.store.add_keyframe(np.array([1, 0, 0, 0, 0, 0, 0], np.float32), float(k),
                                  frame, k)
        for k in range(N_KF - 1):
            lc.process_keyframe(k, detect=False)
        calls = []

        def close(kf, cand, inlier_scale=1.0, calls=calls):
            calls.append((int(kf), int(cand), float(inlier_scale)))
            return inlier_scale == 3.0

        lc._close_loop = close
        lc.calls = calls
    return jlc, tlc


@pytest.mark.parametrize("scale", [3.0, 0.0])
def test_first_sight_closure_matches_reference(scale):
    jlc, tlc = _closer_pair(scale)
    assert tlc.process_keyframe(N_KF - 1) == jlc.process_keyframe(N_KF - 1) == (scale > 0)
    assert tlc.calls == jlc.calls
    detect = [e for e in tlc.events if e["kind"] == "detect"]
    assert detect and [c for c, _ in detect[0]["cands"]] == [2, 3]
    assert not detect[0]["accepted"] and not detect[0]["near"]
    keys = ("kind", "kf", "cand", "early")

    def closed(lc):
        return [{k: e[k] for k in keys} for e in lc.events if e["kind"] == "closed"]

    assert closed(tlc) == closed(jlc)
    if scale > 0:
        assert tlc.calls == [(N_KF - 1, 2, 3.0)]
        assert closed(tlc) == [dict(kind="closed", kf=N_KF - 1, cand=2, early="first")]
    else:
        assert tlc.calls == [] and closed(tlc) == []
