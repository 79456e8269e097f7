"""BENCHMARK.json against the benchmark's contract: names, units, keys,
bounds, and every file the harness finds by name."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_limits():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    cells = len(MANIFEST["workloads"])
    # a full check with 24 cells at this run length fits in 43200 s
    assert (2 + 14 * 24) * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24 and 1 <= len(MANIFEST["configs"]) <= 24
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(section):
    entries = MANIFEST[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if section == "configs":
            assert set(e) == {"name", "source", "file", "reduced", "why"}
            assert e["file"].startswith("benchmark/") and (ROOT / e["file"]).is_file()
            assert e["reduced"] == [] and 1 <= len(e["why"]) <= 200
        elif section == "workloads":
            assert set(e) == {"name", "config", "traffic", "chips", "why"}
            assert e["chips"] == 1 and 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
            assert NAME.match(e["traffic"]) and NAME.match(e["config"])
        else:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher") and e["source"] in SOURCES
        if section == "end_to_end":
            assert set(e) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
            assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
        if section == "per_layer":
            assert set(e) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                              "moves"}
            assert 1 <= len(e["layer"]) <= 200


def _reports(cell):
    return {m["name"] for m in MANIFEST["end_to_end"] if cell in m.get("workloads", [cell])}


def test_every_metric_moves_an_end_to_end_metric_its_cells_report():
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m["workloads"]:
            assert cell in cells and m["moves"] in _reports(cell), (m["name"], cell)
        # a share of a peak or a roofline is in percent
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in MANIFEST["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells


def test_every_cell_reports_setup_another_metric_and_a_layer_metric():
    for w in MANIFEST["workloads"]:
        reported = _reports(w["name"])
        assert "setup_s" in reported and len(reported) >= 2
        assert any(w["name"] in m["workloads"] for m in MANIFEST["per_layer"])
        # a model cell reports the whole step's share of the peak beside a
        # kernel's roofline that moves the same metric
        for m in MANIFEST["per_layer"]:
            if w["name"] in m["workloads"] and m["name"].split(".")[0].endswith("_roofline"):
                assert any(w["name"] in o["workloads"] and "mfu" in o["name"]
                           and o["moves"] == m["moves"] for o in MANIFEST["per_layer"])


def test_every_configuration_keeps_a_cell_and_every_file_is_there():
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    bench = ROOT / "benchmark"
    for w in MANIFEST["workloads"]:
        traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())
        assert (bench / "drivers" / f"{traffic['driver']}.py").is_file()
        assert (bench / "limits" / f"{w['name']}.json").is_file()
        assert (bench / "configs" / f"{w['config']}.json").is_file()
    for m in MANIFEST["per_layer"]:
        assert (bench / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_files_under_paths_are_named_from_name_characters():
    for path in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert len(rel) <= 200 and all(NAME.match(part) for part in rel.split("/")), rel
