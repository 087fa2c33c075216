"""The plain reference of the benchmark's `correct`: GeomConsistentFR's networks,
renderer and training step in plain PyTorch, float32, written from the
published scripts. It imports nothing of the program under test and takes
nothing the program made: the harness hands it the same seeded weights and
inputs it hands the program.

`precision(tf32)` sets the float32 convolutions and matmuls: full float32
(tf32 False) for the reference, TF32 for its lower-precision control.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool = False):
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
