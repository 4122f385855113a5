"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Each port function is held against its JAX counterpart on the CPU: the same
numpy inputs (made from a seed) go through both, results come back as
numpy.  JAX runs on its CPU backend (tests/conftest.py forces it); the
port runs with device="cpu", where the CUDA kernel's wrapper computes the
kernel's plain PyTorch version.
"""

import numpy as np
import torch

# xdist runs several workers on the same cores
torch.set_num_threads(2)

DEV = torch.device("cpu")


def t(a, dtype=None) -> torch.Tensor:
    """numpy -> CPU tensor (uint32 arrays travel as int32 bits, like the port)."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def n(x) -> np.ndarray:
    """tensor / jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def desc_u32(x) -> np.ndarray:
    """Port int32 descriptor tensor -> uint32 numpy (the JAX dtype)."""
    return n(x).view(np.uint32)


def textured_u8(h: int, w: int, seed: int, levels: int = 6) -> np.ndarray:
    """A u8 image of blocky random patches quantized to few grey levels:
    FAST scores on it are integers with many ties."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, levels, (h // 4 + 1, w // 4 + 1))
    img = np.kron(small, np.ones((4, 4)))[:h, :w] * (255 // (levels - 1))
    return img.astype(np.uint8)
