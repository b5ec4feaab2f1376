"""pytest settings of the benchmark's own tests (`pytest portbench/tests`).

Tests that need a CUDA card carry the `card` marker and take the `card`
fixture, which skips them, with the reason, where there is none. Whether a
card exists is decided inside the fixture, never at import."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return torch.device("cuda:0")


@pytest.fixture(autouse=True)
def _few_threads():
    """One test process keeps to a few threads (the CPU runs the port's
    plain kernels, and several test workers may share the machine)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(min(4, saved))
    yield
    torch.set_num_threads(saved)
