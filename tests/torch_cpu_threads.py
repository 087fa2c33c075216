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

After each module it also sets glibc's mmap threshold back to its default
of 128 KiB. glibc raises the threshold (up to 32 MiB) whenever it frees a
mapped chunk, so after a module has freed large CPU tensors, buffers of
that size come from per-thread arenas instead of mappings of their own.
A later module in the same worker that serves from many threads then
keeps the arenas' high water: tests/test_serve.py's soak, which bounds its
RSS growth at 150 MB, grew by 153-213 MB after tests/test_torch_io.py or
tests/test_torch_cli.py, by 25 MB with the threshold reset, by 16-93 MB
alone. (Once set, the threshold stays fixed for the process.)
"""

import ctypes

import pytest
import torch

M_MMAP_THRESHOLD = -3  # glibc's mallopt parameter
GLIBC_DEFAULT_MMAP_THRESHOLD = 128 * 1024


def reset_mmap_threshold() -> None:
    try:
        ctypes.CDLL(None).mallopt(M_MMAP_THRESHOLD, GLIBC_DEFAULT_MMAP_THRESHOLD)
    except (OSError, AttributeError):  # not glibc
        pass


@pytest.fixture(scope="module", autouse=True)
def one_warm_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    x = torch.full((1 << 23,), 3.3)
    torch.exp(x)
    torch.sqrt(x)
    yield
    torch.set_num_threads(before)
    reset_mmap_threshold()
