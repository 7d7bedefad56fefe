"""``BENCHMARK.json`` and every file it names parse and keep to the
benchmark's schema: key sets, name and unit characters, lengths, and a
file for every configuration, traffic mix, limit set and per-layer
metric."""

import json
import os
import re

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
ROOT = os.path.dirname(PB)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    assert len(bench["command"]) <= 32 and all(map(_line, bench["command"]))
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


def test_configs(bench):
    names = [c["name"] for c in bench["configs"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            data = json.load(f)
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and k in data
            assert not k.endswith(("_dim", "_rank"))


def test_workloads(bench):
    cfgs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in cfgs and w["chips"] in (1, 4)
        assert _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        for d, n in (("traffic", w["traffic"]), ("limits", w["name"])):
            with open(os.path.join(PB, d, n + ".json")) as f:
                json.load(f)
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(
        1, len(bench["workloads"]) // 4)


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    names = list(e2e) + [m["name"] for m in bench["per_layer"]]
    assert len(set(names)) == len(names) and "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        assert os.path.exists(os.path.join(PB, "metrics",
                                           m["name"] + ".py"))
        for w in m.get("workloads", []):
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", [w])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        for w in m.get("workloads", []):
            assert w in cells
    for w in cells:       # setup_s, another end-to-end metric, a layer's
        mine = [m for m in bench["end_to_end"]
                if w in m.get("workloads", [w])]
        assert len(mine) >= 2
        assert any(w in m.get("workloads", [w]) for m in bench["per_layer"])


def test_files_named_from_names():
    for d, _, files in os.walk(PB):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), ROOT)
            if "__pycache__" in rel:
                continue
            assert PATH.match(rel), rel
