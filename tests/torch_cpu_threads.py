"""Intra-op threads for the port's CPU tests (imported by tests/test_torch_*.py).

Each test module runs on one PyTorch intra-op thread and restores the count
afterwards, for two reasons:
  * the suite runs in several pytest-xdist workers on a few cores, and each
    worker's pool of spinning OpenMP threads slows every other worker (one
    thread cut the port tests' CPU time by a third);
  * on some x86 CPUs PyTorch's first exp or sqrt in a process, run on its
    intra-op threads, can return values off by 1.5e-4 (exp) or 3.3e-4
    (sqrt) relative in part of the tensor; the second call is right.
    tests/torch_thread_warmup_repro.py shows this with plain torch.exp and
    torch.sqrt and none of the port's code. One warm-up pass makes that
    first call before a test compares anything.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_warm_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    x = torch.full((1 << 23,), 3.3)
    torch.exp(x)
    torch.sqrt(x)
    yield
    torch.set_num_threads(before)
