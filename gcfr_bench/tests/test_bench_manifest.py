"""BENCHMARK.json against the benchmark contract's shapes, names and limits."""

import json
import re

import pytest

from gcfr_bench import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
M = core.manifest()


def one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(M).encode()) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(M["command"]) <= 32 and all(one_line(w) for w in M["command"])
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (core.ROOT / p).is_dir()
    for word in M["command"]:
        assert not word.startswith("/") and ".." not in word


def test_run_seconds_fits_the_check():
    rs = M["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cfg", M["configs"], ids=lambda c: c["name"])
def test_config_entry(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and one_line(cfg["source"]) and one_line(cfg["why"])
    assert cfg["file"].startswith(M["paths"][0] + "/") and (core.ROOT / cfg["file"]).is_file()
    assert len(cfg["reduced"]) <= 16 and all(NAME.match(k) for k in cfg["reduced"])
    data = core.read_json(core.ROOT / cfg["file"])
    assert data["source"] == cfg["source"] and data["reduced"] == cfg["reduced"]
    assert any(w["config"] == cfg["name"] for w in M["workloads"])


@pytest.mark.parametrize("cell", M["workloads"], ids=lambda w: w["name"])
def test_workload_entry(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and one_line(cell["why"])
    assert cell["chips"] in (1, 4)
    assert cell["config"] in {c["name"] for c in M["configs"]}
    wl = core.workload(cell["name"])
    assert wl["config"] == cell["config"] and wl["chips"] == cell["chips"] and wl["why"] == cell["why"]
    reports = [m for m in M["end_to_end"] if "workloads" not in m or cell["name"] in m["workloads"]]
    assert "setup_s" in {m["name"] for m in reports} and len(reports) >= 2
    assert any("workloads" not in m or cell["name"] in m["workloads"] for m in M["per_layer"])


def test_names_unique_and_four_chip_share():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in M[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert len({(w["config"], w["traffic"]) for w in M["workloads"]}) == len(M["workloads"])
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(1, len(M["workloads"]) // 4)


@pytest.mark.parametrize("m", M["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in M["workloads"]}
    assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("m", M["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert one_line(m["layer"])
    e2e = {x["name"]: x for x in M["end_to_end"]}
    assert m["moves"] in e2e
    moved = set(e2e[m["moves"]].get("workloads", {w["name"] for w in M["workloads"]}))
    assert set(m["workloads"]) <= moved
    if m["name"].endswith("_roofline") or "mfu" in m["name"]:
        assert m["unit"] == "%"


def test_layers_named_alike():
    """Metrics of one layer give the same layer name, letter for letter."""
    by_lower = {}
    for m in M["per_layer"]:
        by_lower.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_lower.values())


def test_files_under_paths_are_named_from_name_characters():
    root = core.ROOT / M["paths"][0]
    for path in root.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(core.ROOT).as_posix()
        assert all(NAME.match(part) for part in rel.split("/")), rel
