"""The benchmark's own tests: `python -m pytest gcfr_bench/tests` from the repository's root.

They run on the CPU at small sizes. A test that needs the card takes the
`cuda_device` fixture, which skips without one, and carries the `cuda` marker.

Each workload file `workloads/<cell>.json` has a size file `tests/sizes/<cell>.json`:
`{"small": <overrides at which the cell runs on the CPU>, "card": <the card test's
overrides>, "entry": <the Relighter method whose output the cell fetches and checks, or
null>}`. The tests read the cells from those files, so a cell is added by files alone.
"""

import json
import os
import sys
from pathlib import Path

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

BENCH = Path(__file__).resolve().parent.parent
SIZES_DIR = Path(__file__).resolve().parent / "sizes"
WORKLOAD_FILES = sorted(p.stem for p in (BENCH / "workloads").glob("*.json"))
SIZE_FILES = sorted(p.stem for p in SIZES_DIR.glob("*.json"))


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return "cuda"


def raw_sizes(cell: str) -> dict:
    """The cell's size file as written."""
    path = SIZES_DIR / f"{cell}.json"
    if not path.is_file():
        raise FileNotFoundError(f"the workload file workloads/{cell}.json has no size file tests/sizes/{cell}.json")
    with open(path) as f:
        return json.load(f)


def sizes(cell: str) -> dict:
    """The cell's size file, its CPU config overrides merged over the 64x64 render every
    cell runs at on the CPU."""
    from gcfr_bench import run

    out = raw_sizes(cell)
    config = {"pipeline": {"render": {"img_height": 64, "img_width": 64}}}
    run.merge(config, out["small"].get("config", {}))
    out["small"]["config"] = config
    return out


SIZES = {cell: sizes(cell) for cell in SIZE_FILES}
