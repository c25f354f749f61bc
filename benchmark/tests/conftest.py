import pytest


@pytest.fixture(autouse=True, scope="session")
def one_intra_op_thread():
    """One intra-op CPU thread, as the command sets (benchmark/run.py): with
    PyTorch's default pool of a thread a core, the pools of several test
    workers spin on the same cores and starve the Systems' own threads."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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
