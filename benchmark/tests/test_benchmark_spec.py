"""BENCHMARK.json against the contract the harness is built to: names,
units, metric wiring, and every file a cell names found by name."""

import json
import os
import re

import pytest

from benchmark import core

SPEC = core.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
ALL_METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("name", [m["name"] for m in ALL_METRICS]
                         + [c["name"] for c in SPEC["configs"]]
                         + [w["name"] for w in SPEC["workloads"]])
def test_names(name):
    assert NAME.match(name), name


def test_names_unique():
    for group in (ALL_METRICS, SPEC["configs"], SPEC["workloads"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", ALL_METRICS, ids=lambda m: m["name"])
def test_units_and_sources(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    allowed = {"end_to_end": ("host_clock", "device_trace")}
    if metric in SPEC["end_to_end"]:
        assert metric["source"] in allowed["end_to_end"]
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_moves_is_reported_by_each_cell(metric):
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert metric["moves"] in e2e
    cells = metric.get("workloads", [w["name"] for w in SPEC["workloads"]])
    for cell in cells:
        reported = {m["name"] for m in core.cell_metrics(cell, "end_to_end")}
        assert metric["moves"] in reported, (metric["name"], cell)


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(cell):
    _, entry, config, traffic = core.cell_files(cell["name"])
    assert cell["chips"] == 1
    assert entry["reduced"] == [] and config["reduced"] == []
    assert os.path.exists(os.path.join(core.HERE, "entries", traffic["entry"] + ".py"))
    for m in core.cell_metrics(cell["name"], "per_layer"):
        assert hasattr(core.reader(m["name"]), "read")
    e2e = {m["name"] for m in core.cell_metrics(cell["name"], "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert core.cell_metrics(cell["name"], "per_layer")
    assert len(cell["why"]) <= 200 and "\n" not in cell["why"]


def test_config_files_state_their_cut():
    for c in SPEC["configs"]:
        conf = core.load_json(os.path.join(core.ROOT, c["file"]))
        assert conf["source"] == c["source"]
        assert conf["precision"] in ("bf16", "tf32", "fp32")
        assert set(conf["limits"]) and all(v >= 0 for v in conf["limits"].values())
        assert os.path.exists(os.path.join(core.ROOT, conf["reference"]))


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_reference_module_found_by_name(entry):
    """A configuration brings its own reference module, named in its
    file: the model class and the forward's FLOPs, no table to edit."""
    ref = core.reference(core.load_json(os.path.join(core.ROOT, entry["file"])))
    assert isinstance(ref.Model, type)
    assert ref.forward_flops(398, 199) > ref.forward_flops(298, 149) > 0


def test_spec_is_small():
    with open(os.path.join(core.ROOT, "BENCHMARK.json"), "rb") as f:
        assert len(f.read()) < 64 * 1024
    json.dumps(SPEC)
