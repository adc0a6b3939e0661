"""pytest settings of the benchmark's own tests (``perfbench/tests``)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA GPU; skips with a reason without "
        "one (run on the chip as README.md says)")


@pytest.fixture
def cuda():
    """The CUDA device, or a skip where there is none; decided here, never
    while a module is imported."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the chip")
    return torch.device("cuda")
