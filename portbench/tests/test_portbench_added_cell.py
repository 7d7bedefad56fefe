"""A cell, a configuration, a traffic mix, an end-to-end and a per-layer
metric are added as new files and entries alone (here the training entry's
cell, which the benchmark does not hold yet): in a copy of the benchmark, the added cell
is found by name, its metric's reader is found and read, and a run of it
goes through (tiny, on the CPU)."""

import json
import os
import shutil
import time

from portbench import run as R
from portbench.tests import tiny

ROOT = tiny.ROOT


def test_cell_added_as_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    pb = root / "portbench"
    cfg = dict(tiny.train_cell()["config"], name="tiny-net")
    (pb / "configs" / "tiny-net.json").write_text(json.dumps(cfg))
    traffic = tiny.train_cell()["traffic"]
    (pb / "traffic" / "train-tiny.json").write_text(json.dumps(traffic))
    (pb / "limits" / "tiny-train.json").write_text(json.dumps(
        {"label_miss": 0, "reader_gap": 0}))
    (pb / "metrics" / "steps_seen.py").write_text(
        "def read(run):\n    return run.get('units') or None\n")
    bench["configs"].append({"name": "tiny-net", "source": "test",
                             "file": "portbench/configs/tiny-net.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-train", "config": "tiny-net",
                               "traffic": "train-tiny", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "train_step_ms", "unit": "ms",
                                "better": "lower", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["tiny-train"]})
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "data", "moves": "train_step_ms",
                               "workloads": ["tiny-train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    copy = R.load_module(str(pb / "run.py"), "portbench_run_copy")
    assert copy.ROOT == str(root)
    c = copy.cell(bench, "tiny-train")
    assert c["config"]["name"] == "tiny-net"
    names = [m["name"] for m in copy.metrics_of(bench, "tiny-train", True)]
    assert "steps_seen" in names and "data_wait_ms" not in names
    res = copy.run_cell(c, 42, 1.0, False, device="cpu",
                        t_start=time.perf_counter())
    assert res["correct"], res["compared"]
    reader = copy.load_module(str(pb / "metrics" / "steps_seen.py"), "ss")
    assert reader.read({**res["data"]}) == res["attempted"]
