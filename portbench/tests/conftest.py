"""Settings of the benchmark's own tests (``python -m pytest
portbench/tests`` from the root of the repo)."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'gpu: needs a CUDA device (skipped without one)')


@pytest.fixture
def card():
    """Skip unless a CUDA device is there (decided when the test runs)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
