"""The manifest and the files the harness finds by name."""

import json
import os
import re
import shutil

import pytest

import core
from conftest import BENCH, ROOT

MANIFEST = core.load_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_manifest_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["benchmark"]
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_found_by_name(workload):
    cell = core.resolve(MANIFEST, workload)
    entry = {c["name"]: c for c in MANIFEST["configs"]}[cell.entry["config"]]
    assert os.path.samefile(os.path.join(ROOT, entry["file"]),
                            core.find("configs", cell.entry["config"]))
    assert core.reference_module(cell.entry["config"]).reference
    assert cell.limits and all("limit" in v for v in cell.limits.values())
    for m in cell.end_to_end + cell.per_layer:
        assert callable(core.metric_reader(m["name"]))
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_names_and_units():
    names = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    names += CELLS + [c["name"] for c in MANIFEST["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in MANIFEST["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200


def test_metric_arrows():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in MANIFEST["per_layer"]:
        target = e2e[m["moves"]]
        for w in m["workloads"]:
            assert "workloads" not in target or w in target["workloads"], m
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    # metrics of one layer name it letter for letter
    assert all(len(v) == 1 for v in layers.values())


def test_traffic_file_added_without_edit(tmp_path):
    """A later PR adds a mix as a file and a manifest entry; the harness
    finds it with no edit of its code."""
    copy = tmp_path / "repo"
    shutil.copytree(BENCH, copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads(json.dumps(MANIFEST))
    traffic = core.load_json(os.path.join(BENCH, "traffic", "wf.json"))
    traffic["wavelengths_nm"]["num"] = 1024
    (copy / "benchmark" / "traffic" / "wf1024.json").write_text(json.dumps(traffic))
    (copy / "benchmark" / "limits" / "ground16_f64.wf1024.json").write_text(
        json.dumps({"radiance_max": {"limit": 1.0}}))
    man["workloads"].append({"name": "ground16_f64.wf1024",
                             "config": "ground16_f64", "traffic": "wf1024",
                             "chips": 1, "why": "test"})
    saved = core.HERE
    try:
        core.HERE = str(copy / "benchmark")
        cell = core.resolve(man, "ground16_f64.wf1024")
    finally:
        core.HERE = saved
    assert cell.traffic["wavelengths_nm"]["num"] == 1024
    assert cell.config["name"] == "ground16_f64"
