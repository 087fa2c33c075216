"""The port imports neither JAX nor the JAX package, and never falls back to the CPU.

The child process also blocks OpenCV, imageio and Pillow: without them the
port's image files go through its own PNG codec. It blocks orbax,
tensorstore, msgpack and zstandard too, and reads the committed orbax
fixture (tests/golden/orbax_relightnet_seed0) through the port's own reader.
"""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "geomconsistentfr_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "geomconsistentfr_tpu", "orbax", "tensorstore", "msgpack", "zstandard")

_CHILD = r"""
import importlib, importlib.util, pkgutil, sys, tempfile
# Nor does the port need an image codec package (OpenCV, imageio, Pillow) or
# orbax's stack (orbax, tensorstore, msgpack, zstandard).
for name in ("jax", "jaxlib", "flax", "geomconsistentfr_tpu", "cv2", "imageio", "PIL", "orbax", "tensorstore",
             "msgpack", "zstandard"):
    sys.modules[name] = None  # any import of them now raises ImportError
import geomconsistentfr_torch
for info in pkgutil.walk_packages(geomconsistentfr_torch.__path__, "geomconsistentfr_torch."):
    importlib.import_module(info.name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))

import torch
from geomconsistentfr_torch.config import preset_single_image
from geomconsistentfr_torch.infer import Relighter
from geomconsistentfr_torch.models.relightnet import RelightNet

assert not torch.cuda.is_available()
cfg = preset_single_image()
state = RelightNet(cfg.model).state_dict()
try:
    Relighter(cfg, state)
except RuntimeError as e:
    assert "device='cpu'" in str(e), e
else:
    raise AssertionError("Relighter without a device ran with no CUDA device")
Relighter(cfg, state, device="cpu")

from geomconsistentfr_torch.config import preset_target_lighting_train
from geomconsistentfr_torch.train import Trainer

try:
    Trainer(preset_target_lighting_train())
except RuntimeError as e:
    assert "device='cpu'" in str(e), e
else:
    raise AssertionError("Trainer without a device ran with no CUDA device")
Trainer(preset_target_lighting_train(), device="cpu")

# Image files through the port's own PNG codec.
import os
import numpy as np
from geomconsistentfr_torch.utils import io as image_io

tmp = tempfile.mkdtemp()
pixels = np.random.default_rng(0).integers(0, 256, (32, 32, 3)).astype(np.uint8)
image_io.write_image_u8(os.path.join(tmp, "x.png"), pixels)
assert np.array_equal(image_io.read_image_u8(os.path.join(tmp, "x.png"), 32), pixels)
assert image_io.read_mask_u8(os.path.join(tmp, "x.png"), 16).shape == (16, 16)

# The CLI and the server refuse to fall back to the CPU.
torch.save(state, os.path.join(tmp, "w.pth"))
from geomconsistentfr_torch import cli, serve

for main, argv in ((cli.main, ["relight", "--checkpoint", os.path.join(tmp, "w.pth"), "--image", "x.png",
                                "--mask", "x.png", "--light-preset", "A00E45"]),
                   (cli.main, ["train", "--epochs", "1", "--out", os.path.join(tmp, "run")]),
                   (cli.main, ["lpips-score", "--data-root", tmp, "--random-trunk"]),
                   (serve.main, ["--checkpoint", os.path.join(tmp, "w.pth"), "--port", "0"])):
    try:
        main(argv)
    except RuntimeError as e:
        assert "device='cpu'" in str(e), e
    else:
        raise AssertionError(f"{main.__module__}.main without --device ran with no CUDA device")
# The committed orbax fixture, through the port's reader, to its hashes.
import hashlib, json
from geomconsistentfr_torch.convert import state_dict_from_jax_variables
from geomconsistentfr_torch.utils.checkpoint import restore_variables

want = json.load(open("tests/golden/orbax_relightnet_seed0.sha256.json"))["leaves"]
tree = restore_variables("tests/golden/orbax_relightnet_seed0")
got = {f"{group}.{module}.{leaf}": hashlib.sha256(v.tobytes()).hexdigest()
       for group, modules in tree.items() for module, leaves in modules.items() for leaf, v in leaves.items()}
assert got == {k: v["sha256"] for k, v in want.items()}
assert len(state_dict_from_jax_variables(tree)) > 300
print("ISOLATED")
"""


def test_port_imports_without_jax_and_refuses_cpu_fallback():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "ISOLATED" in proc.stdout


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_statement(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path.name}:{node.lineno} imports {name}"


# The JAX package's native loader: its directory at the repo's root, and the
# library it builds there. The port builds its own from csrc/ into build/native/.
JAX_NATIVE = (re.compile(r"(?<![\w/])native/"), re.compile(r"[)\]]\s*/\s*[\"']native[\"']"),
              re.compile("libgcfr_dataloader"))


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_port_file_names_the_jax_native_loader(path):
    text = path.read_text()
    for pattern in JAX_NATIVE:
        found = pattern.search(text)
        assert found is None, f"{path.name} names {found.group(0)!r}"
