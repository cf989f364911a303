"""The benchmark's own tests.  ``card``-marked tests need a CUDA card and
skip without one; whether there is one is decided inside the fixture, when
a test runs, never at import or collection.

    python -m pytest portbench/tests -q -o addopts=""
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (runs on the H100)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the H100")
    return "cuda"
