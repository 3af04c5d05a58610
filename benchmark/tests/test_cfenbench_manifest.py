"""BENCHMARK.json and the files it names against the contract's rules."""

import json
import re

import pytest

from benchmark.run import HERE, ROOT, Cell, load_json, reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = load_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert MANIFEST["paths"] == ["benchmark"]
    assert len(MANIFEST["command"]) <= 32


def test_names_and_units():
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[section]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((section in ("end_to_end", "per_layer"), entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
    metrics = [n for is_metric, n in names if is_metric]
    assert len(metrics) == len(set(metrics))
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_per_layer_metrics_name_their_cells():
    for m in MANIFEST["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= set(CELLS), m["name"]


def test_end_to_end_rules():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_and_metrics(cell):
    c = Cell(cell, MANIFEST)
    assert c.entry["chips"] == 1
    assert len(c.end_to_end) >= 2 and c.per_layer
    assert importlib_ok(c)
    reported = {m["name"] for m in c.end_to_end}
    for m in c.per_layer:
        assert m["moves"] in reported
        assert callable(reader(m["name"]))
    assert set(c.limits) == set(
        json.loads((HERE / "workloads" / f"{cell}.json").read_text())["limits"])


def importlib_ok(c):
    return hasattr(c.loop(), "run")


def test_every_config_is_used_and_files_are_under_paths():
    used = {w["config"] for w in MANIFEST["workloads"]}
    for cfg in MANIFEST["configs"]:
        assert cfg["name"] in used
        assert cfg["file"].startswith("benchmark/")
        data = load_json(ROOT / cfg["file"])
        assert data["reduced"] == cfg["reduced"] == []
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_file_names_use_name_characters():
    for path in HERE.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
