"""CUDA FAST+NMS kernel binding (replaces spslam_tpu/ops/fast_pallas.py).

The kernel source is csrc/fast_nms.cu (sm_90a).  It is compiled with nvcc
into a shared library with a plain C interface at first use, into
spslam_tpu_torch/_build/ (keyed by the source's hash), and loaded with
ctypes.  Nothing is built or loaded at import.

`fast_nms_scores_levels` is the dispatch `ops/fast.detect_levels` calls
once per frame: for CUDA tensors it launches the kernel once over all
pyramid levels (or raises); for CPU tensors it computes the plain version
`fast_nms_scores_levels_plain`.  There is no fallback from one to the
other.  `fast_nms_scores` is the same for one image without a border.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import NamedTuple

import torch

from .fast import fast_score_map, nms3x3

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "fast_nms.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
MAX_LEVELS = 16
TILE = 30   # a tile is TILE x TILE outputs (csrc/fast_nms.cu TILE; load() checks it)

# Kernel launches made through fast_nms_scores_levels_cuda (a plain counter
# that callers reset and read to prove a run went through the kernel).
LAUNCHES = 0

_lib = None
_tables: dict = {}
_table_lock = threading.Lock()   # the cached tables' pointers are rewritten per call


class _Level(ctypes.Structure):
    _fields_ = [("img", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("H", ctypes.c_int), ("W", ctypes.c_int),
                ("tile0", ctypes.c_int), ("tiles_x", ctypes.c_int)]


class _LevelTable(ctypes.Structure):
    _fields_ = [("lv", _Level * MAX_LEVELS)]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build(verbose: bool = False) -> str:
    """Compile csrc/fast_nms.cu (if not already built) and return the path
    of the shared library.  Writes to a temporary name, then renames, so
    concurrent processes never load a half-written file."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = os.path.join(BUILD_DIR, f"libfast_nms_{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, SOURCE]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose:
        print(res.stderr.strip())
    os.replace(tmp, out)
    return out


def load():
    """Load the kernel library, building it if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.fast_nms_levels_launch.argtypes = [
            _LevelTable, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p,
        ]
        lib.fast_nms_levels_launch.restype = ctypes.c_int
        lib.fast_nms_rate_launch.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.fast_nms_rate_launch.restype = ctypes.c_int
        lib.fast_nms_rate_ops.argtypes = [ctypes.c_int]
        lib.fast_nms_rate_ops.restype = ctypes.c_int
        lib.fast_nms_tile.argtypes = []
        lib.fast_nms_tile.restype = ctypes.c_int
        if lib.fast_nms_tile() != TILE:
            raise RuntimeError(f"fast_nms: the kernel's tile is {lib.fast_nms_tile()}, "
                               f"the level table's {TILE}")
        _lib = lib
    return _lib


def _level_table(sizes: tuple, border: int):
    """The ctypes level table for these level sizes, built once: tiles are
    laid over each level's interior [border, H-border) x [border, W-border)
    (one tile if that is empty), levels in the order given.  Only the
    pointers change from call to call.  Returns (table, its level entries,
    n_tiles)."""
    key = (sizes, border)
    hit = _tables.get(key)
    if hit is None:
        table = _LevelTable()
        n_tiles = 0
        for lv, (h, w) in zip(table.lv, sizes):
            tiles_x = max(1, -(-(w - 2 * border) // TILE))
            tiles_y = max(1, -(-(h - 2 * border) // TILE))
            lv.H, lv.W, lv.tile0, lv.tiles_x = h, w, n_tiles, tiles_x
            n_tiles += tiles_x * tiles_y
        hit = _tables[key] = (table, list(table.lv)[: len(sizes)], n_tiles)
    return hit


def _check_args(levels, th_low: float, th_high: float, border: int, device_type: str):
    """Raise ValueError on anything the kernel does not take."""
    levels = tuple(levels)
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"fast_nms: needs 1..{MAX_LEVELS} levels, got {len(levels)}")
    if not (th_low >= 0 and th_high >= 0 and int(border) == border and border >= 0):
        raise ValueError(f"fast_nms: thresholds and border must be >= 0, got "
                         f"th_low={th_low} th_high={th_high} border={border}")
    device = levels[0].device
    if device.type != device_type:
        raise ValueError(f"fast_nms: needs {device_type} tensors, got {device}")
    for i, img in enumerate(levels):
        if (img.device != device or img.dtype is not torch.float32 or img.dim() != 2
                or not img.is_contiguous() or img.numel() == 0):
            raise ValueError(
                f"fast_nms: level {i} must be a non-empty contiguous 2-D float32 tensor on "
                f"{device}, got {img.dtype} {tuple(img.shape)} on {img.device} "
                f"contiguous={img.is_contiguous()}")
    return levels


def fast_nms_scores_levels_cuda(levels, th_low: float, th_high: float, border: int) -> list:
    """CUDA [H_l, W_l] float32 levels -> their NMS'd FAST score maps (0 = no
    corner, 0 in the border frame), all in ONE kernel launch.

    Launches on the current stream; allocates only the outputs."""
    global LAUNCHES
    levels = _check_args(levels, th_low, th_high, border, "cuda")
    lib = load()
    table, entries, n_tiles = _level_table(tuple([img.shape for img in levels]), int(border))
    outs = [torch.empty_like(img) for img in levels]
    device = levels[0].device
    stream = torch.cuda.current_stream(device).cuda_stream
    with _table_lock:
        for lv, img, out in zip(entries, levels, outs):
            lv.img = img.data_ptr()
            lv.out = out.data_ptr()
        args = (table, len(levels), n_tiles, float(th_low), float(th_high), int(border),
                stream)
        if torch.cuda.current_device() == device.index:
            err = lib.fast_nms_levels_launch(*args)
        else:
            with torch.cuda.device(device):
                err = lib.fast_nms_levels_launch(*args)
    if err != 0:
        raise RuntimeError(f"fast_nms_levels_launch failed: cudaError {err}")
    LAUNCHES += 1
    return outs


def fast_nms_scores_levels_plain(levels, th_low: float, th_high: float, border: int) -> list:
    """The plain PyTorch version of the kernel: per level
    nms3x3(fast_score_map(img)), then 0 outside the detection interior."""
    outs = []
    for img in levels:
        h, w = img.shape
        score = nms3x3(fast_score_map(img, th_low, th_high))
        masked = torch.zeros_like(score)
        masked[border : h - border, border : w - border] = (
            score[border : h - border, border : w - border]
        )
        outs.append(masked)
    return outs


def fast_nms_scores_levels(levels, th_low: float, th_high: float, border: int) -> list:
    """Dispatch: one kernel launch for CUDA levels, the plain PyTorch
    version for CPU levels."""
    levels = tuple(levels)
    kind = levels[0].device.type if levels else "cpu"
    if kind == "cuda":
        return fast_nms_scores_levels_cuda(levels, th_low, th_high, border)
    if kind != "cpu":
        raise ValueError(f"fast_nms_scores_levels: unsupported device {levels[0].device}")
    return fast_nms_scores_levels_plain(_check_args(levels, th_low, th_high, border, "cpu"),
                                        th_low, th_high, border)


def fast_nms_scores_cuda(img: torch.Tensor, th_low: float, th_high: float) -> torch.Tensor:
    """[H, W] float32 CUDA image -> [H, W] NMS'd FAST score map (0 = none):
    the same kernel with a table of one level and no border."""
    return fast_nms_scores_levels_cuda((img,), th_low, th_high, 0)[0]


def fast_nms_scores(img: torch.Tensor, th_low: float, th_high: float) -> torch.Tensor:
    """Dispatch for one image without a border."""
    return fast_nms_scores_levels((img,), th_low, th_high, 0)[0]


# Lane operations, as the kernel computes them.  Every scored pixel takes
# the compass test: 4 float32 subtractions, 6 min/max, 2 compares, 1 or.
# A pixel that passes takes the ring: 32 subtractions (ring - centre,
# centre - ring); per polarity 16 + 16 three-input minima and 8 maxima for
# the 16 nine-arcs, 1 maximum of the two; 2 compares, 2 selects and 1 add
# for the thresholds.  An output pixel: 8 compares, 7 ands, 1 select for
# NMS.  Min/max, compare, select and logic run at half the add rate.
OPS_COMPASS = {"add": 4, "minmax": 9}
OPS_RING = {"add": 33, "minmax": 85}
OPS_NMS = {"add": 0, "minmax": 16}


class FastNmsWork(NamedTuple):
    bytes: int        # each level read once and written once, float32
    ops: int          # all lane operations
    minmax_ops: int   # those of them that are min/max/compare/select/logic
    scored_px: int    # pixels that need a score
    ring_px: int      # pixels counted with the full ring


def scored_region(h: int, w: int, border: int) -> tuple:
    """(row slice, column slice) of the pixels of an [h, w] level that need
    a score: the interior and the 1-px ring around it that NMS reads,
    clipped to the image; empty slices if there is no interior."""
    if h - 2 * border <= 0 or w - 2 * border <= 0:
        return slice(0, 0), slice(0, 0)
    return (slice(max(border - 1, 0), min(h - border + 1, h)),
            slice(max(border - 1, 0), min(w - border + 1, w)))


def fast_nms_work(level_sizes, border: int, ring_px: int | None = None) -> FastNmsWork:
    """Least work of fast_nms_scores_levels on levels of these sizes: the
    bytes it must move and the lane operations it must do.  `ring_px` is
    the number of scored pixels that pass the compass test on the data at
    hand (count them with ops/fast.compass_reject over `scored_region`);
    None counts the ring for every scored pixel, the most the data could
    need."""
    n_bytes = scored = outputs = 0
    for h, w in level_sizes:
        n_bytes += 8 * h * w
        rows, cols = scored_region(h, w, border)
        scored += (rows.stop - rows.start) * (cols.stop - cols.start)
        outputs += max(h - 2 * border, 0) * max(w - 2 * border, 0)
    ring = scored if ring_px is None else ring_px
    add, minmax = (scored * OPS_COMPASS[k] + ring * OPS_RING[k] + outputs * OPS_NMS[k]
                   for k in ("add", "minmax"))
    return FastNmsWork(bytes=n_bytes, ops=add + minmax, minmax_ops=minmax, scored_px=scored,
                       ring_px=ring)


def measure_rate(kind: int, device=None, iters: int = 4096, blocks: int = 132 * 16) -> float:
    """Lane operations per second of the card in a register-only loop of
    float32 adds (kind 0), float32 min/max (1) or the three-input int32
    min/max the kernel uses (2): best of 5 timed launches."""
    lib = load()
    device = torch.device("cuda" if device is None else device)
    seed = torch.arange(8, dtype=torch.float32, device=device)
    out = torch.empty(blocks * 256, dtype=torch.float32, device=device)
    best = float("inf")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for i in range(6):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            err = lib.fast_nms_rate_launch(kind, seed.data_ptr(), out.data_ptr(), iters,
                                           blocks, stream)
            b.record()
            if err != 0:
                raise RuntimeError(f"fast_nms_rate_launch failed: cudaError {err}")
            b.synchronize()
            if i:   # the first launch warms up
                best = min(best, a.elapsed_time(b) * 1e-3)
    return blocks * 256 * iters * lib.fast_nms_rate_ops(kind) / best
