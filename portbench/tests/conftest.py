"""The benchmark's own tests (CPU, tiny sizes). Tests that need the card
carry the ``cuda`` marker and skip here, decided inside a fixture."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: the benchmark's cells run on the chip")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
