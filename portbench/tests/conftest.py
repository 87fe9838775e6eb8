"""The benchmark's own tests (``python -m pytest portbench/tests``): on the
CPU at small sizes, and those marked ``card`` on a CUDA device."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# several MKL threads made the port's small CPU solves hang in LASWP faults
torch.set_num_threads(1)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)
