"""Runs of each cell on the CPU at a small size, past the harness's look for a card: a
sound run is correct, and each fault the cell can have, planted in the timed path,
makes `correct` come out false."""

import json
import os
import subprocess
import sys

import pytest
import torch

from gcfr_bench import core, run
from gcfr_bench.tests.conftest import SIZES, WORKLOAD_FILES, sizes

SEED = 2 ** 31 + 11


def small_run(cell, seconds=0.2):
    return run.run_cell(cell, SEED, seconds, False, device="cpu", overrides=sizes(cell)["small"])


def xor_first(fn):
    def altered(*args, **kwargs):
        out = fn(*args, **kwargs).clone()
        out[0] ^= 64
        return out
    return altered


@pytest.mark.parametrize("cell,method", [(cell, SIZES[cell]["entry"]) for cell in WORKLOAD_FILES
                                         if cell in SIZES and SIZES[cell]["entry"]])
def test_relight_answer_altered(monkeypatch, cell, method):
    from geomconsistentfr_torch.infer import Relighter

    monkeypatch.setattr(Relighter, method, xor_first(getattr(Relighter, method)))
    assert small_run(cell)["correct"] is False


def test_serve_answer_altered(monkeypatch):
    monkeypatch.setenv("GCFR_BENCH_FAULT", "answer_altered")
    assert small_run("single_image.serve_overload", seconds=2.0)["correct"] is False


def test_serve_refuses_a_server_that_loaded_jax(monkeypatch):
    """The server is a process of its own: what it loads is checked from its record."""
    monkeypatch.setenv("GCFR_BENCH_FAULT", "forbidden_module")
    with pytest.raises(RuntimeError, match=r"loaded \['jax'\]"):
        small_run("single_image.serve_overload", seconds=1.0)


@pytest.mark.parametrize("nets", ["g_and_d", "d"])
def test_train_state_unchanged(monkeypatch, nets):
    """A step that returns its state unchanged (its losses still computed): both networks',
    or the discriminator's alone, which takes one Adam step of the three compared."""
    from geomconsistentfr_torch import train

    step = train.train_step

    def unchanged(state, batch, cfg, use_skips, **kw):
        held = (state.g, state.d) if nets == "g_and_d" else (state.d,)
        saved = [{k: v.clone() for k, v in m.state_dict().items()} for m in held]
        out = step(state, batch, cfg, use_skips, **kw)
        for m, sd in zip(held, saved):
            m.load_state_dict(sd)
        return out

    monkeypatch.setattr(train, "train_step", unchanged)
    r = small_run("target_lighting_train.b3")
    assert r["correct"] is False and r["check"]["median_change_gap"]["value"] > r["check"]["median_change_gap"]["limit"]


def test_train_half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from geomconsistentfr_torch import train

    step = train.train_step

    def half(state, batch, cfg, use_skips, **kw):
        b = batch["image"].shape[0]
        return step(state, {k: v[: b - b // 2] for k, v in batch.items()}, cfg, use_skips, **kw)

    monkeypatch.setattr(train, "train_step", half)
    assert small_run("target_lighting_train.b3")["correct"] is False


GUARD = """
import json, sys
from gcfr_bench import core, run
from gcfr_bench.tests.conftest import sizes
results = {}
for cell in sorted(p.stem for p in (core.BENCH / "workloads").glob("*.json")):
    r = run.run_cell(cell, 77, 0.5 if "serve" not in cell else 2.0, cell.endswith("sweep64"), device="cpu",
                     overrides=sizes(cell)["small"])
    results[cell] = r["correct"]
print(json.dumps({"correct": results, "forbidden": core.forbidden_modules(sys.modules)}))
"""


def test_sound_runs_are_correct_and_load_no_jax():
    """Every workload file's sound run is correct; no module the runs load is JAX's or the
    JAX package's (top-level names compared whole: geomconsistentfr_torch is allowed), in
    this process or, for the serving driver, in the server's (its record is checked)."""
    env = {**os.environ, "PYTHONPATH": str(core.ROOT)}
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", GUARD], cwd=core.ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["forbidden"] == []
    assert all(res["correct"].values()), res


def test_forbidden_names_compare_whole():
    assert core.forbidden_modules(["geomconsistentfr_torch.infer", "jaxtyping", "numpy"]) == []
    assert core.forbidden_modules(["jax.numpy", "geomconsistentfr_tpu.config", "flax"]) == [
        "flax", "geomconsistentfr_tpu", "jax"]


REFERENCE = """
import importlib, sys
from gcfr_bench import core
for path in sorted((core.BENCH / "reference").glob("[!_]*.py")):
    importlib.import_module("gcfr_bench.reference." + path.stem)
print(sorted({m.split(".")[0] for m in sys.modules} & {"geomconsistentfr_torch", "geomconsistentfr_tpu", "jax"}))
"""


def test_reference_imports_nothing_of_the_program():
    out = subprocess.run([sys.executable, "-c", REFERENCE], cwd=core.ROOT, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(core.ROOT)}, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    for path in (core.BENCH / "reference").glob("*.py"):
        assert "geomconsistentfr" not in path.read_text().replace("GeomConsistentFR", "")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [cell for cell in WORKLOAD_FILES if cell in SIZES])
def test_control_fails_on_the_card(cuda_device, cell):
    """A sound run is correct, and the control (the reference in TF32 in the program's
    place) fails at least one of the cell's limits."""
    wl = core.workload(cell)
    run.merge(wl, SIZES[cell]["card"])  # the cell at its own shapes, with fewer calls
    drv = core.driver_module(wl["driver"]).Driver(wl, core.config(wl["config"]), SEED, cuda_device)
    drv.traced = False
    drv.setup()
    drv.window(1.0)
    drv.memory_peak()
    drv.free()
    assert drv.check().correct
    control = drv.control()
    assert any(control[k] > limit for k, limit in wl["check"].items()), control
    torch.cuda.empty_cache()
