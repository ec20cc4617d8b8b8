"""The benchmark's own tests (``python -m pytest benchmark/tests``): they
rehearse the harness on the CPU at small sizes.  Tests marked ``card``
run the harness on a CUDA device and skip without one; whether there is a
card is decided inside the ``card`` fixture, never at import."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the harness runs its cells on a card")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def rig(tmp_path_factory):
    """Every cell on the small CPU rig (``benchmark.tests.small``)."""
    from benchmark.tests import small

    return small.Rig(tmp_path_factory.mktemp("rig"))
