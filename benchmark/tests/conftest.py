import pytest


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is visible (decided here, at run
    time, never while the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def tiny_root(tmp_path):
    from benchmark.tests.tiny import make_root

    return make_root(tmp_path)
