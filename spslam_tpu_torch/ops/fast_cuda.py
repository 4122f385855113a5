"""CUDA FAST+NMS kernel binding (replaces spslam_tpu/ops/fast_pallas.py).

The kernel source is csrc/fast_nms.cu (sm_90a).  It is compiled with nvcc
into a shared library with a plain C interface at first use, into
spslam_tpu_torch/_build/ (keyed by the source's hash), and loaded with
ctypes.  Nothing is built or loaded at import.

`fast_nms_scores` is the dispatch `ops/fast.detect_levels` calls: for a
CUDA tensor it launches the kernel (or raises); for a CPU tensor it
computes the plain version nms3x3(fast_score_map(img)).  There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

from .fast import fast_score_map, nms3x3

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "fast_nms.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# Kernel launches made through fast_nms_scores_cuda (a plain counter that
# callers reset and read to prove a run went through the kernel).
LAUNCHES = 0

_lib = None


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


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.fast_nms_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
        ]
        lib.fast_nms_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def fast_nms_scores_cuda(img: torch.Tensor, th_low: float, th_high: float) -> torch.Tensor:
    """[H, W] float32 CUDA image -> [H, W] NMS'd FAST score map (0 = none).

    Launches on the current stream; allocates only the output."""
    global LAUNCHES
    if img.device.type != "cuda":
        raise ValueError(f"fast_nms_scores_cuda needs a CUDA tensor, got {img.device}")
    if img.dtype != torch.float32 or img.dim() != 2 or not img.is_contiguous():
        raise ValueError(
            f"fast_nms_scores_cuda needs a contiguous 2-D float32 tensor, got "
            f"{img.dtype} {tuple(img.shape)} contiguous={img.is_contiguous()}"
        )
    lib = _load()
    H, W = img.shape
    out = torch.empty_like(img)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.fast_nms_launch(img.data_ptr(), out.data_ptr(), H, W,
                                  float(th_low), float(th_high), stream)
    if err != 0:
        raise RuntimeError(f"fast_nms_launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def fast_nms_scores(img: torch.Tensor, th_low: float, th_high: float) -> torch.Tensor:
    """Dispatch: the CUDA kernel for a CUDA tensor, the plain PyTorch
    version for a CPU tensor."""
    if img.device.type == "cuda":
        return fast_nms_scores_cuda(img, th_low, th_high)
    if img.device.type != "cpu":
        raise ValueError(f"fast_nms_scores: unsupported device {img.device}")
    return nms3x3(fast_score_map(img, th_low, th_high))
