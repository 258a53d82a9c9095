"""``BENCHMARK.json`` against the contract's rules, and every name in it
backed by a file the harness finds by that name."""

from __future__ import annotations

import copy
import json
import re

import pytest
from conftest import ROOT, config_of, manifest

from benchmark import run as br
from ssd_tpu_torch.utils.yaml_subset import read_yaml

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = ROOT / "benchmark"


def test_top_level_keys_and_command():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert m["command"] == ["python3", "benchmark/run.py"] and m["paths"] == ["benchmark"]
    assert 1 <= m["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 runs a cell, each run_seconds + 60, 180 s a cell
    assert (2 + 14 * 24) * (m["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(m)) <= 64 * 1024


@pytest.mark.parametrize("held_back", [False, True])
def test_names_units_and_text(held_back):
    m = manifest(held_back)
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in m[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    assert len(names) == len(set(names))
    for e in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert e["source"] in SOURCES
        assert set(e) <= {"name", "unit", "better", "bound", "source", "layer", "moves",
                          "workloads"}


@pytest.mark.parametrize("held_back", [False, True])
def test_entries_have_exactly_the_contract_keys(held_back):
    m = manifest(held_back)
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}, c["name"]
        assert c["source"].startswith("https://") and len(c["reduced"]) <= 16
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}, w["name"]
        assert w["chips"] in (1, 4)
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound", "source"}, e["name"]
    for e in m["per_layer"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}, e["name"]


@pytest.mark.parametrize("held_back", [False, True])
def test_end_to_end_bounds(held_back):
    m = manifest(held_back)
    assert any(e["name"] == "setup_s" for e in m["end_to_end"])
    for e in m["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25


@pytest.mark.parametrize("held_back", [False, True])
def test_every_per_layer_metric_moves_a_metric_its_cells_report(held_back):
    m = manifest(held_back)
    reported = {w["name"]: {e["name"] for e in m["end_to_end"]
                            if w["name"] in e.get("workloads", [w["name"]])}
                for w in m["workloads"]}
    for e in m["per_layer"]:
        for cell in e.get("workloads", []):
            assert e["moves"] in reported[cell], (e["name"], cell)
        assert (BENCH / "metrics" / f"{e['name']}.py").exists()
    for cell, e2e in reported.items():
        assert "setup_s" in e2e and len(e2e) >= 2
        assert br.cell_metrics(m, cell, True), cell


def test_a_per_layer_metric_that_lists_no_cells_is_read_wherever_its_metric_is():
    """The contract lets a per-layer entry leave out ``workloads``: it is
    then read in every cell that reports the metric it moves."""
    m = manifest(held_back=True)
    m["per_layer"].append({"name": "x", "unit": "%", "better": "lower", "source": "device_trace",
                           "layer": "device", "moves": "serve_p95_ms"})
    assert "x" in [e["name"] for e in br.cell_metrics(m, "large_serve", True)]
    assert "x" not in [e["name"] for e in br.cell_metrics(m, "fast_train", True)]


@pytest.mark.parametrize("held_back", [False, True])
def test_layers_name_one_layer_the_same_way(held_back):
    layers = {}
    for e in manifest(held_back)["per_layer"]:
        layers.setdefault(e["layer"].split(" ")[0], set()).add(e["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


@pytest.mark.parametrize("held_back", [False, True])
def test_cells_files_and_limits(held_back):
    m = manifest(held_back)
    assert sum(w["chips"] == 4 for w in m["workloads"]) <= max(1, len(m["workloads"]) // 4)
    pairs = {(w["config"], w["traffic"]) for w in m["workloads"]}
    assert len(pairs) == len(m["workloads"])
    for w in m["workloads"]:
        cell = json.loads((BENCH / "workloads" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "drivers" / f"{cell['driver']}.py").exists()
        assert all(v >= 0 for v in cell["limits"].values())
        assert w["config"] in {c["name"] for c in m["configs"]}


@pytest.mark.parametrize("name", ["scaled_large_fused", "fast_plus"])
def test_configuration_is_the_shipped_yaml_with_its_listed_changes(name):
    doc = config_of(name)
    entry = next(c for c in manifest(held_back=True)["configs"] if c["name"] == name)
    shipped = read_yaml((ROOT / doc["source"]).read_text(), doc["source"])
    want = copy.deepcopy(shipped)
    for key, (value, _why) in doc["overrides"].items():
        *path, last = key.split(".")
        node = want
        for p in path:
            node = node[p]
        node[last] = value
    got = copy.deepcopy(doc["config"])
    for key in doc["reduced"]:
        assert key in entry["reduced"]
        want.pop(key)
        got.pop(key)
    assert got.pop("vocab") == json.loads((ROOT / "configs" / "vocab.json").read_text())
    assert got == want
    changed = {k.split(".")[0] for k in doc["overrides"]} | set(doc["reduced"])
    assert changed == set(entry["reduced"])
    enc, shipped_enc = doc["config"]["model"]["encoder"], shipped["model"]["encoder"]
    for width in ("d_model", "num_heads", "ffn_dim", "depthwise_conv_kernel_size", "input_dim"):
        assert enc[width] == shipped_enc[width]
