"""One intra-op thread for the port's CPU tests (tests/test_torch_*.py
import `one_torch_thread`, an autouse fixture, into their namespace).

The port's tensors in these tests are small, and the suite runs under six
pytest workers on one machine (`-n 6 --dist loadfile`): each torch
process's OpenMP team (one thread a core) then waits at every parallel
region for teammates that the other workers' teams keep off the cores.
Measured on an 8-core CPU host: tests/test_torch_trainer.py's two-epoch
test takes 1.65 s alone, 582 s in each of six copies run at once (390 s
in a six-worker run of the whole suite), and 1.9 s in each of six copies
at one thread. The thread count changes no check: it moves float32 sums
by rounding only, inside every tolerance.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one intra-op thread while the module's tests run; the
    count restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
