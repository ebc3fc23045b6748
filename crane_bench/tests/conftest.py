"""Settings of the benchmark's own tests (``python -m pytest crane_bench/tests``).

Tests marked ``card`` need an NVIDIA card; each decides inside its fixture,
never while the module is imported, and skips on a machine without one.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.cuda.get_device_name(0)
