"""PyTorch/CUDA port of the point-only RGB-D SLAM main path of `spslam_tpu`.

Same module names as the JAX package (ops/fast.py, tracking/tracker.py, ...)
so every function has an obvious counterpart; the JAX package stays the
reference and the tests hold each port function against it on the CPU.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; asking for CUDA on a machine without it raises instead
of falling back.
"""

from __future__ import annotations

import torch

# Float32 matmuls must stay full float32 on the card: the BRIEF bit test is
# the SIGN of a float32 product (ops/brief.py), the orientation moments feed
# a 30-bin quantizer, and TF32's 10-bit mantissa flips both.  These are
# also PyTorch's defaults for matmul, but cuDNN's default is TF32 on.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """None means CUDA.  Raises if CUDA is asked for and absent.  A CUDA
    device gets its index (the current device when none is given), so a
    worker thread can use it explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "spslam_tpu_torch: CUDA is not available; pass device='cpu' "
                "explicitly to run the plain PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
