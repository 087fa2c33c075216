"""Cells, drivers, configurations and metric readers are found by name, from files."""

import pytest

from gcfr_bench import core, run

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
