"""pytest settings of the benchmark's own tests (python -m pytest benchmark/).

Tests marked `cuda` need an NVIDIA card; the `cuda_device` fixture skips
them where there is none (decided when the test runs, never at import).
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card (run on the card: "
                                       "python -m pytest benchmark/ -m cuda)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
