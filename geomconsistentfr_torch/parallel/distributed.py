"""Process-group setup (port of geomconsistentfr_tpu/parallel/distributed.py).

One process per rank. Under torchrun every process calls `initialize()`,
which reads RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE and MASTER_ADDR /
MASTER_PORT from the environment; in a single process it does nothing.

The backend is chosen once, from the device count, never as a fallback after
a failure: NCCL when every rank of the host has a card of its own, gloo when
ranks share a card (NCCL refuses two ranks on one GPU; gloo takes CUDA
tensors) or run on the CPU.

Every rank's `initialize` (and `spawn`'s start-up) also makes one control
group over the world with the gloo backend, in the same place on every
rank (`dist.new_group` is a collective; it is never made lazily on one
rank). Host messages that must reach every rank whatever the mesh's backend
(the multi-rank server's requests, serve.py) go through it:
`control_group()`. `is_writer()` is true on rank 0 or in a single process:
the one rank that writes files and prints a command's result.

`spawn` starts `nprocs` ranks on this host with a `file://` rendezvous, for
the tests and chip_smoke.py:

    distributed.spawn(fn, 2, "cuda", args=(...))   # fn(device, *args) in each rank

Typical entry point:

    from geomconsistentfr_torch.parallel import distributed, mesh
    device = distributed.initialize()
    m = mesh.make_mesh_grid(n_data, n_samples, device)
    trainer = Trainer(cfg, data=..., mesh=m)
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# How long a collective or the rendezvous waits for a missing rank.
TIMEOUT = datetime.timedelta(minutes=5)
_CONTROL = None  # the gloo control group over the world, made by _init


def rank_device(local_rank: int, local_world: int, device: str = "cuda") -> torch.device:
    """This rank's device: `cuda:<local_rank>` when each rank has its own card,
    `cuda:0` when the ranks share one, the CPU when `device` is 'cpu'."""
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the ranks on the CPU")
    n = torch.cuda.device_count()
    return torch.device("cuda", local_rank if n >= local_world else 0)


def choose_backend(device: torch.device, local_world: int) -> str:
    """'nccl' when every rank of the host has a card of its own, else 'gloo'."""
    if device.type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def _init(rank: int, world: int, local_rank: int, local_world: int, device: str, init_method: str) -> torch.device:
    dev = rank_device(local_rank, local_world, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(choose_backend(dev, local_world), init_method=init_method,
                            rank=rank, world_size=world, timeout=TIMEOUT)
    global _CONTROL
    _CONTROL = dist.new_group(backend="gloo", timeout=TIMEOUT)
    return dev


def control_group():
    """The gloo group over the world that `initialize` made (None in a single process)."""
    if not dist.is_initialized():
        return None
    if _CONTROL is None:
        raise RuntimeError("the process group was not joined through distributed.initialize or spawn, so it "
                           "has no control group")
    return _CONTROL


def is_writer() -> bool:
    """True on rank 0, or in a single process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def shutdown() -> None:
    """Leave the process group (if this process joined one)."""
    global _CONTROL
    if dist.is_initialized():
        dist.destroy_process_group()
    _CONTROL = None


def initialize(device: str = "cuda") -> Optional[torch.device]:
    """Join the process group torchrun describes; None in a single process.

    Returns this rank's device. `device` 'cpu' runs the ranks on the CPU (gloo).
    """
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        return None
    rank = int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return _init(rank, world, local_rank, local_world, device, "env://")


def local_batch_slice(global_batch: int) -> slice:
    """This process's contiguous slice of a batch split evenly over the world."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    per = global_batch // n
    if per * n != global_batch:
        raise ValueError(f"batch {global_batch} does not split evenly over {n} processes")
    return slice(rank * per, (rank + 1) * per)


def _spawned(rank: int, fn: Callable, world: int, device: str, init_file: str, args: tuple) -> None:
    dev = _init(rank, world, rank, world, device, f"file://{init_file}")
    try:
        fn(dev, *args)
    finally:
        shutdown()


def spawn(fn: Callable, nprocs: int, device: str = "cuda", init_file: Optional[str] = None,
          args: tuple = (), join: bool = True):
    """Run fn(device, *args) in `nprocs` new processes, one rank each.

    The ranks meet through `init_file`, which must not exist yet (by default
    a fresh file in a temporary directory, removed afterwards). `fn` must be
    importable by name (a module-level function), as the spawn start method
    requires. With `join` (the default) this waits for every rank and raises
    if one raised; the others are then terminated. With join=False it
    returns torch.multiprocessing's ProcessContext at once (pass an
    `init_file`): call its `join()` until it returns True.
    """
    if init_file is not None:
        return mp.spawn(_spawned, args=(fn, nprocs, device, os.path.abspath(init_file), args),
                        nprocs=nprocs, join=join)
    if not join:
        raise ValueError("spawn(join=False) needs an init_file that outlives the call")
    tmp = tempfile.mkdtemp(prefix="gcfr_rdzv_")
    try:
        return mp.spawn(_spawned, args=(fn, nprocs, device, os.path.join(tmp, "init"), args),
                        nprocs=nprocs, join=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
