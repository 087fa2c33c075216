"""Checkpoints: orbax variable trees, and step-level train states.

  * `save_variables` / `restore_variables`: the counterparts of
    geomconsistentfr_tpu/utils/checkpoint.py:43-64, a tree of arrays (model
    variables, e.g. what `cli convert` writes) in an orbax checkpoint
    directory, through the port's own reader and writer (utils/orbax.py):
    it reads what the JAX package's orbax writes, OCDBT or not, and writes
    the layout without OCDBT, which orbax restores.
  * step-level train states: the layout and retention of
    geomconsistentfr_tpu/utils/checkpoint.py:67-105 (`<root>/step_<8-digit
    step>/`, resume from the highest step, keep the newest N), with the
    whole train state in one `torch.save`d `train_state.pt` per directory.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional

import torch

from geomconsistentfr_torch.utils.orbax import read_checkpoint, write_checkpoint

STATE_FILE = "train_state.pt"


def save_variables(path: str, tree: Any) -> None:
    """Write a tree (nested dicts and lists of numpy arrays, tensors or numbers)
    to directory `path` as an orbax checkpoint (replacing what is there)."""
    write_checkpoint(path, tree)


def restore_variables(path: str, template: Optional[Any] = None) -> Any:
    """The tree of an orbax checkpoint directory: numpy arrays, Python numbers for scalars.

    With a `template` (a tree of the same structure), the result takes its
    structure and checks every leaf's shape against the template's, as
    orbax's restore with PyTreeRestore(item=template) does."""
    tree = read_checkpoint(path)
    if template is None:
        return tree
    return _like(template, tree, ())


def _like(template, tree, where: tuple):
    name = ".".join(map(str, where)) or "the root"
    if isinstance(template, dict):
        if not isinstance(tree, dict) or set(template) != set(tree):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"{name}: the checkpoint holds {got}, the template {sorted(template)}")
        return {k: _like(v, tree[k], where + (k,)) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if not isinstance(tree, list) or len(tree) != len(template):
            raise ValueError(f"{name}: the checkpoint's sequence does not match the template's {len(template)}")
        return type(template)(_like(v, t, where + (i,)) for i, (v, t) in enumerate(zip(template, tree)))
    shape = getattr(template, "shape", None)
    if shape is not None and tuple(shape) != tuple(getattr(tree, "shape", ())):
        raise ValueError(f"{name}: shape {getattr(tree, 'shape', ())} in the checkpoint, {tuple(shape)} in the "
                         "template")
    return tree


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
