"""Tests of the benchmark harness. They import no JAX. Tests that need an
NVIDIA GPU carry the `card` marker and skip, inside their fixture, where
there is none."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU; skips where there is none")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return "cuda:0"
