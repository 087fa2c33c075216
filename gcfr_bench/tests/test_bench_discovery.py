"""Cells, drivers, configurations and metric readers are found by name, from files."""

import pytest

from gcfr_bench import core, run
from gcfr_bench.tests.conftest import SIZE_FILES, raw_sizes, sizes

M = core.manifest()


WORKLOAD_FILES = sorted(p.stem for p in (core.BENCH / "workloads").glob("*.json"))


@pytest.mark.parametrize("cell", WORKLOAD_FILES)
def test_cell_files_resolve(cell):
    """Every workload file, in BENCHMARK.json or kept for a later cell, resolves."""
    wl = core.workload(cell)
    cfg = core.config(wl["config"])
    assert cfg["name"] == wl["config"]
    assert hasattr(core.driver_module(wl["driver"]), "Driver")
    assert set(wl["check"]) and all(v > 0 for v in wl["check"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in M["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(core.metric_reader(metric).read)


def test_manifest_cells_have_workload_files():
    assert {w["name"] for w in M["workloads"]} <= set(WORKLOAD_FILES)


@pytest.mark.parametrize("metric,file", [("idle_pct.sweep", "idle_pct.py"), ("idle_pct.train", "idle_pct.py"),
                                         ("k1_roofline.sweep", "k1_roofline.py"), ("mfu.relight", "mfu.py"),
                                         ("mfu.train", "mfu.train.py"), ("march_ms.train", "march_ms.py"),
                                         ("serve.batch_rows", "serve.batch_rows.py")])
def test_split_metrics_share_their_quantity_s_reader(metric, file):
    """A metric split by the end-to-end metric it moves is read by its quantity's file,
    unless it has a file of its own."""
    assert core.metric_reader(metric).__file__ == str(core.BENCH / "metrics" / file)


def test_cell_metrics_selects_by_workloads():
    manifest = {"per_layer": [{"name": "a", "workloads": ["x"]}, {"name": "b", "workloads": ["y"]}, {"name": "c"}],
                "end_to_end": [{"name": "rate", "workloads": ["x"]}, {"name": "setup_s"}]}
    assert [m["name"] for m in run.cell_metrics(manifest, "x", "per_layer")] == ["a", "c"]
    assert [m["name"] for m in run.cell_metrics(manifest, "y", "end_to_end")] == ["setup_s"]
    names = {m["name"] for m in run.cell_metrics(M, "single_image.batch64", "per_layer")}
    assert "k1_roofline" in names and "mfu.relight" in names


def test_merge_is_deep():
    target = {"a": {"b": 1, "c": {"d": 2}}, "e": 3}
    run.merge(target, {"a": {"c": {"d": 4}}, "e": 5})
    assert target == {"a": {"b": 1, "c": {"d": 4}}, "e": 5}


def test_every_workload_file_has_a_size_file_and_every_size_file_a_workload():
    """A cell's test sizes are found by name: tests/sizes/<cell>.json beside workloads/<cell>.json."""
    missing = sorted(set(WORKLOAD_FILES) - set(SIZE_FILES))
    orphans = sorted(set(SIZE_FILES) - set(WORKLOAD_FILES))
    assert not missing, f"workload files without a size file: {[f'gcfr_bench/tests/sizes/{c}.json' for c in missing]}"
    assert not orphans, f"size files without a workload file: {[f'gcfr_bench/workloads/{c}.json' for c in orphans]}"


def keys_within(overrides: dict, base: dict) -> bool:
    """Every key of `overrides`, at every depth, is a key of `base` there."""
    return all(k in base and (not isinstance(v, dict) or (isinstance(base[k], dict) and keys_within(v, base[k])))
               for k, v in overrides.items())


@pytest.mark.parametrize("cell", SIZE_FILES)
def test_size_file_shape(cell):
    """A size file holds the CPU overrides, the card's and the checked entry; the overrides
    name only keys the cell's files have. Read as written, before the CPU render is merged in."""
    from geomconsistentfr_torch.infer import Relighter

    s = raw_sizes(cell)
    assert set(s) == {"small", "card", "entry"}
    assert s["entry"] is None or callable(getattr(Relighter, s["entry"], None))
    wl = core.workload(cell)
    assert set(s["small"]) <= {"workload", "config"}
    for overrides in (s["small"].get("workload", {}), s["card"]):
        assert keys_within(overrides, wl)
    assert keys_within(s["small"].get("config", {}), core.config(wl["config"]))


def test_cpu_render_merges_into_a_size_file_s_own_config(monkeypatch, tmp_path):
    """A size file's own CPU config overrides survive the 64x64 render merged under them."""
    from gcfr_bench.tests import conftest

    (tmp_path / "x.json").write_text('{"small": {"config": {"pipeline": {"render": {"num_sample_points": 40,'
                                     ' "img_width": 32}}}}, "card": {}, "entry": null}')
    monkeypatch.setattr(conftest, "SIZES_DIR", tmp_path)
    render = sizes("x")["small"]["config"]["pipeline"]["render"]
    assert render == {"img_height": 64, "img_width": 32, "num_sample_points": 40}
