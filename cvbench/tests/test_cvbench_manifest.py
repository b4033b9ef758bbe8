"""BENCHMARK.json against the benchmark's contract, and every file it names."""

import json
import math
import os
import re

import pytest

from cvbench import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return run.manifest()


def _one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_names_and_units(bench):
    assert set(bench) == TOP_KEYS
    assert 1 <= bench["run_seconds"] <= 51 and bench["run_seconds"] == int(bench["run_seconds"])
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
    assert len(bench["command"]) <= 32 and all(_one_line(w) for w in bench["command"])
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _one_line(c["source"]) and _one_line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _one_line(w["why"])
        assert w["chips"] in (1, 4)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _one_line(m["layer"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert len(json.dumps(bench)) <= 64 * 1024


def test_cells_report_what_they_should(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        reporting = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m.get("workloads", cells)) <= reporting, m["name"]
    for c in cells:
        assert any(c in m.get("workloads", cells) for m in bench["end_to_end"] if m["name"] != "setup_s")
        assert any(c in m.get("workloads", cells) for m in bench["per_layer"])
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_four_chip_share(bench):
    cells = bench["workloads"]
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, math.floor(0.25 * len(cells)))


def test_every_named_file_exists(bench):
    root = str(run.ROOT)
    confs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert c["file"].startswith(bench["paths"][0] + "/")
        body = run.load_json(run.ROOT / c["file"])
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        assert w["config"] in confs
        spec = run.cell_spec(w["name"], bench)
        assert spec["mix"]["runner"] and spec["limits"]
        assert os.path.isfile(os.path.join(root, "cvbench", "runners", spec["mix"]["runner"] + ".py"))
        assert os.path.isfile(os.path.join(root, "cvbench", "checks", spec["config"]["model"] + ".py"))
        assert w["chips"] in spec["config"]["chips"]
    for m in bench["per_layer"]:
        assert callable(run.metric_reader(m["name"]))
