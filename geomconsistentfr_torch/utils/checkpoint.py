"""Step-level train-state checkpoints: `torch.save` into step_* directories.

The layout and retention of geomconsistentfr_tpu/utils/checkpoint.py:67-105
(`<root>/step_<8-digit step>/`, resume from the highest step, keep the newest
N), with the whole train state in one `train_state.pt` per directory. Loading
the JAX package's orbax checkpoints belongs to the serving slice.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional

import torch

STATE_FILE = "train_state.pt"


def save_train_state(path: str, state: Any) -> None:
    """torch.save `state` (tensors, numbers, nested dicts and lists) into directory `path`."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))  # a crash mid-save leaves no half file


def load_train_state(path: str, map_location=None) -> Any:
    """The state saved by `save_train_state` in directory `path`."""
    return torch.load(os.path.join(path, STATE_FILE), map_location=map_location, weights_only=True)


def _step_dirs(root: str) -> list[tuple[int, str]]:
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        if name.startswith("step_"):
            try:
                steps.append((int(name.split("_", 1)[1]), name))
            except ValueError:
                continue
    return sorted(steps)


def latest_step_dir(root: str) -> Optional[str]:
    """The highest-numbered step_* checkpoint directory under root, or None."""
    steps = _step_dirs(root)
    if not steps:
        return None
    return os.path.join(root, steps[-1][1])


def prune_step_dirs(root: str, keep: int) -> list[str]:
    """Delete all but the newest `keep` step_* directories; keep <= 0 keeps all.

    Returns the removed paths. The reference keeps every per-epoch save
    (train_raytracing_...py:684-685) and fills the disk on long runs.
    """
    if keep <= 0:
        return []
    removed = []
    for _, name in _step_dirs(root)[:-keep]:
        path = os.path.join(root, name)
        shutil.rmtree(path)
        removed.append(path)
    return removed
