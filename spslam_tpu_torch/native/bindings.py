"""ctypes bindings of the port's C++ host components (port of
spslam_tpu/native/bindings.py): the BoW inverted index of the keyframe
database (src/bow_index.cc) and the covisibility counter (src/covis.cc).

The library is built with g++ at first use into spslam_tpu_torch/_build/
(named by the sources' hash, so an edit rebuilds it) and loaded from there.
Every consumer keeps a pure-Python path for a machine without a compiler:
`get_lib()` returns None when the build or the load fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = [os.path.join(_DIR, "src", f) for f in ("bow_index.cc", "covis.cc")]
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-Wall"]

_lib = None
_tried = False
# set when this process compiled the library (False: it was already built)
BUILT_HERE = False
LIB_PATH = None


def build() -> str:
    """Compile the sources (if not already built); returns the library's
    path.  Writes a temporary name, then renames it."""
    global BUILT_HERE
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"libspslam_native_{h.hexdigest()[:12]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cxx = os.environ.get("CXX", "g++")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, *SOURCES], capture_output=True,
                         text=True, timeout=120)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{cxx} failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    BUILT_HERE = True
    return out


def get_lib():
    """The native library (building it if needed), or None."""
    global _lib, _tried, LIB_PATH
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        LIB_PATH = build()
        lib = ctypes.CDLL(LIB_PATH)
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None

    i32p, f32p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float)
    lib.bow_new.restype = ctypes.c_void_p
    lib.bow_new.argtypes = [ctypes.c_int32]
    lib.bow_free.argtypes = [ctypes.c_void_p]
    lib.bow_add.argtypes = [ctypes.c_void_p, ctypes.c_int32, i32p, f32p, ctypes.c_int32]
    lib.bow_erase.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.bow_pair_score.restype = ctypes.c_float
    lib.bow_pair_score.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
    lib.bow_query.restype = ctypes.c_int32
    lib.bow_query.argtypes = [
        ctypes.c_void_p, i32p, f32p, ctypes.c_int32, i32p, ctypes.c_int32, ctypes.c_float,
        i32p, f32p, ctypes.c_int32,
    ]
    lib.covis_count.argtypes = [
        i32p, ctypes.c_int32, i32p, ctypes.c_int32, ctypes.c_int32, i32p, ctypes.c_int32,
    ]
    _lib = lib
    return _lib


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeBowIndex:
    """C++ inverted index with the KeyFrameDatabase query semantics."""

    def __init__(self, n_words: int):
        self._lib = get_lib()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._h = self._lib.bow_new(n_words)

    def __del__(self):
        if getattr(self, "_h", None) and self._lib is not None:
            self._lib.bow_free(self._h)
            self._h = None

    @staticmethod
    def _to_arrays(bow: dict[int, float]):
        words = np.fromiter(bow.keys(), np.int32, len(bow))
        wts = np.fromiter(bow.values(), np.float32, len(bow))
        return words, wts

    def add(self, kf: int, bow: dict[int, float]):
        words, wts = self._to_arrays(bow)
        self._lib.bow_add(self._h, kf, _i32p(words), _f32p(wts), len(words))

    def erase(self, kf: int):
        self._lib.bow_erase(self._h, kf)

    def pair_score(self, a: int, b: int) -> float:
        return float(self._lib.bow_pair_score(self._h, a, b))

    def query(self, bow: dict[int, float], exclude, min_score: float, max_results: int = 8):
        if not bow:
            return []
        words, wts = self._to_arrays(bow)
        excl = np.fromiter(exclude, np.int32, len(exclude))
        out_ids = np.zeros(max_results, np.int32)
        out_scores = np.zeros(max_results, np.float32)
        n = self._lib.bow_query(
            self._h, _i32p(words), _f32p(wts), len(words), _i32p(excl), len(excl), min_score,
            _i32p(out_ids), _f32p(out_scores), max_results,
        )
        return [(int(out_ids[i]), float(out_scores[i])) for i in range(n)]


def covis_count(kf_obs: np.ndarray, pt_obs_kf: np.ndarray, kf: int,
                n_keyframes: int) -> np.ndarray | None:
    """Shared-point counts of keyframe kf with every keyframe [n_keyframes];
    None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    kf_obs = np.ascontiguousarray(kf_obs, np.int32)
    pt_obs_kf = np.ascontiguousarray(pt_obs_kf, np.int32)
    out = np.zeros(n_keyframes, np.int32)
    lib.covis_count(_i32p(kf_obs), len(kf_obs), _i32p(pt_obs_kf), pt_obs_kf.shape[1], kf,
                    _i32p(out), n_keyframes)
    return out
