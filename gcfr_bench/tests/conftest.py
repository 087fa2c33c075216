"""The benchmark's own tests: `python -m pytest gcfr_bench/tests` from the repository's root.

They run on the CPU at small sizes. A test that needs the card takes the
`cuda_device` fixture, which skips without one, and carries the `cuda` marker.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return "cuda"


# Small sizes at which each cell runs on the CPU: 64x64 images, few rows.
SMALL = {
    "single_image.batch64": {"workload": {"traffic": {"batch": 2, "pool_batches": 2, "checked_calls": 1}}},
    "single_image.sweep64": {"workload": {"traffic": {"lights": 3, "pool_calls": 2, "checked_calls": 1}}},
    "single_image.serve_overload": {"workload": {"traffic": {"rate_per_s": 4, "checked_requests": 3, "payloads": 4,
                                                         "workers": 4}}},
    "target_lighting_train.b3": {"workload": {"traffic": {"steps_per_epoch": 3}}},
}
for _v in SMALL.values():
    _v["config"] = {"pipeline": {"render": {"img_height": 64, "img_width": 64}}}
