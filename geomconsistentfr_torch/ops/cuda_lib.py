"""Build, load, launch and count the port's hand-written CUDA kernels (csrc/*.cu).

Each wrapper (ops/shadows_cuda.py, ops/epilogue_cuda.py, ops/conv3x3_cuda.py,
ops/pack_cuda.py) declares its library once, at import: a `Library` of its
source and, for each kernel by the name its launches count under, the C entry
point and its argtypes. The library is built and opened at its first launch,
once a process; `Library.launch` runs an entry point on torch's current
stream, raises if the launcher refuses, and counts what it accepted in
`LAUNCHES`.
A test swaps the loaded library for a fake by replacing `Library.load`.

The sources have a plain C interface, so a build takes seconds: `nvcc` for
sm_90a with -fmad=false (no contraction into FMAs the plain versions do not
make), into `<repo>/build/kernels/` (git-ignored) as `<stem>_<key>.so`, the
key a hash of the source and the flags, so a later process loads the build
and an edited source builds anew. Every entry point takes the kernel's
arguments, then the stream, and returns the CUDA error code, 0 when the
launch was accepted. `check` and `ptr` are the wrappers' shared checks on
the tensors they hand a kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

# Launches of each kernel that its launcher accepted since its count was last set to 0, by the
# name a `Library` declares (every declared name is here, at 0, from its wrapper's import).
LAUNCHES: dict[str, int] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def build_key(source: Path) -> str:
    """The build's key: a hash of the source and the flags."""
    return hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]


def build(source: Path) -> tuple[Path, str]:
    """Compile `source` unless a build of it exists; (library, ptxas log)."""
    key = build_key(source)
    lib = BUILD_DIR / f"{source.stem}_{key}.so"
    log = BUILD_DIR / f"{source.stem}_{key}.log"
    if lib.exists():
        return lib, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed to build {source.name}:\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees a whole file
    log.write_text(proc.stdout + proc.stderr)
    return lib, proc.stdout + proc.stderr


class Library:
    """A kernel library: its .cu source and, for each kernel by the name its launches count
    under, (the C entry point that launches it, the entry point's argtypes before the stream)."""

    def __init__(self, source: Path, kernels: dict[str, tuple[str, list]]):
        self.source, self.kernels, self._fns = source, kernels, None
        for name in kernels:
            LAUNCHES.setdefault(name, 0)

    def load(self) -> dict:
        """The entry points by kernel name, argtypes and restype bound: built and opened once."""
        if self._fns is None:
            lib = ctypes.CDLL(str(build(self.source)[0]))
            fns = {}
            for name, (entry, argtypes) in self.kernels.items():
                fn = fns[name] = getattr(lib, entry)
                fn.argtypes, fn.restype = [*argtypes, ctypes.c_void_p], ctypes.c_int
            self._fns = fns
        return self._fns

    def launch(self, kernel: str, dev: torch.device, *args, count_as: Optional[str] = None) -> None:
        """Launch `kernel` with `args` on `dev`'s current stream; raise if its launcher refuses,
        else count one launch under `count_as`, by default the kernel's own name."""
        with torch.cuda.device(dev):
            err = self.load()[kernel](*args, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
        LAUNCHES[count_as or kernel] += 1


def ptr(x: Optional[torch.Tensor]) -> int:
    """A tensor's data pointer; 0, the kernels' absent argument, for None."""
    return 0 if x is None else x.data_ptr()


def check(name: str, t: torch.Tensor, shape: tuple, device: torch.device,
          fmt: torch.memory_format = torch.contiguous_format, aligned: bool = False) -> None:
    """Refuse a tensor a kernel does not read: on another device, not float32, of another
    shape, not dense in the memory order `fmt`, or with `aligned`, not 16-byte aligned."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous(memory_format=fmt):
        raise ValueError(f"{name} must be dense in the memory order {fmt}, got strides {t.stride()}")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
