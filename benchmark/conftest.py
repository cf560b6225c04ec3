"""pytest settings of the benchmark's own tests (benchmark/tests/).

Tests that need a CUDA card carry the ``chip`` marker and take the
``cuda_device`` fixture, which skips them where there is no card. Whether
there is one is decided inside the fixture, never while a module is
imported. Run them on the card with
``python -m pytest benchmark/tests -m chip``.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    from benchmark.core import env

    env.fix_cache_dirs()
    env.float32_exact()
    return torch.device("cuda", 0)
