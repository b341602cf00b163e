"""The `card` fixture of the benchmark's tests: it skips a test when no CUDA
card is present, decided when the test runs, never at import."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest benchmark/tests -m card` there")
    return torch.device("cuda", 0)
