"""BENCHMARK.json against the benchmark's contract, and every cell's
files found by name."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def line_ok(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_paths():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and all(line_ok(w) for w in cmd)
    assert cmd[1].startswith(MANIFEST["paths"][0] + "/")
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) < 64 * 1024


def test_budget_fits_with_24_cells():
    n = 24
    runs = 2 + 14 * n
    total = runs * (MANIFEST["run_seconds"] + 60) + n * 2 * 90 + 1200
    assert total <= 43200


def test_entries_have_just_their_keys_and_valid_names():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for section, want in keys.items():
        names = [e["name"] for e in MANIFEST[section]]
        assert len(names) == len(set(names))
        for e in MANIFEST[section]:
            extra = set(e) - want
            assert extra <= ({"workloads"} if section in (
                "end_to_end", "per_layer") else set()), (section, e["name"])
            assert want <= set(e)
            assert NAME.match(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"])
                assert e["better"] in ("lower", "higher")
    metric_names = [m["name"] for s in ("end_to_end", "per_layer")
                    for m in MANIFEST[s]]
    assert len(metric_names) == len(set(metric_names))


def test_configs():
    assert 1 <= len(MANIFEST["configs"]) <= 24
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in MANIFEST["workloads"]}
    for c in MANIFEST["configs"]:
        assert c["name"] in used
        assert line_ok(c["source"]) and line_ok(c["why"])
        assert c["file"].startswith(MANIFEST["paths"][0] + "/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / "portbench" / "reference"
                / f"{c['name']}.py").is_file()


def test_workloads_find_their_files():
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert 1 <= len(pairs) <= 24
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(pairs) // 4)
    for w in MANIFEST["workloads"]:
        assert w["chips"] in (1, 4)
        assert line_ok(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        traffic = json.loads((ROOT / "portbench" / "traffic"
                              / f"{w['traffic']}.json").read_text())
        assert (ROOT / "portbench" / "drivers"
                / f"{traffic['driver']}.py").is_file()
        limits = json.loads((ROOT / "portbench" / "limits"
                             / f"{w['name']}.json").read_text())
        assert limits and all(isinstance(v, (int, float))
                              for v in limits.values())


def _reports(cell):
    e2e = [m for m in MANIFEST["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in MANIFEST["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return names, layer


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_reports_what_the_contract_asks(cell):
    names, layer = _reports(cell)
    assert "setup_s" in names and len(names) >= 2
    assert layer
    for m in layer:
        assert m["moves"] in names, (m["name"], cell)


def test_metrics():
    e2e = MANIFEST["end_to_end"]
    assert 1 <= len(e2e) <= 16
    assert any(m["name"] == "setup_s" for m in e2e)
    for m in e2e:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in MANIFEST["workloads"]}
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line_ok(m["layer"])
        assert m["moves"] in {e["name"] for e in e2e}
        assert set(m.get("workloads", [])) <= cells
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())

