"""CPU tests of the benchmark (``python -m pytest stitchbench/tests``).

Tests that need the card carry the repository's ``cuda`` marker and skip
where ``torch.cuda.is_available()`` is False."""
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

HERE = Path(__file__).resolve().parent


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (the port's CUDA "
        "kernels); skipped where torch.cuda.is_available() is False")


@pytest.fixture(autouse=True, scope="session")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny():
    """The small grid traffic the CPU tests run (a copy each test)."""
    with open(HERE / "tiny_grid.json") as f:
        return json.load(f)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
