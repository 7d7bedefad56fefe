"""``lite-batch-fd``: found by name in ``BENCHMARK.json`` (its
configuration, traffic and limits, the metrics a run prints), and a tiny
run of it on the CPU is ``correct``, each reply carrying its subject's
read time (``read_ms``'s reading)."""

import json
import os
import time

from portbench import run as R
from portbench.tests import tiny


def test_found_by_name():
    with open(os.path.join(tiny.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    c = R.cell(bench, "lite-batch-fd")
    assert c["workload"]["chips"] == 1
    assert c["config"]["name"] == "pifuhd-flagship-lite"
    assert c["traffic"]["request"] == "directory"
    e2e = [m["name"] for m in R.metrics_of(bench, "lite-batch-fd", False)]
    assert e2e == ["mesh_s", "setup_s"]
    per = {m["name"] for m in R.metrics_of(bench, "lite-batch-fd", True)}
    assert {"read_ms", "encode_ms", "query_roofline_pct", "march_ms",
            "mesh_write_ms", "device_idle_pct.mesh", "mesh_mfu_pct"} <= per
    for m in per:
        assert os.path.exists(os.path.join(tiny.ROOT, "portbench", "metrics",
                                           m + ".py"))


def test_runs_tiny(tmp_path):
    p = str(tmp_path / "tiny")
    tiny.checkpoint(p)
    res = R.run_cell(tiny.serve_cell(p, "lite-batch-fd"), 323456789012345,
                     2.0, False, device="cpu", t_start=time.perf_counter())
    assert res["correct"], res["compared"]
    assert res["attempted"] >= 2 and res["numbers"]["checked"] == 2
    # each subject's read is timed on its reply: read_ms reads the cell
    reader = R.load_module(os.path.join(tiny.ROOT, "portbench", "metrics",
                                        "read_ms.py"), "read_ms")
    replies = res["data"]["replies"]
    assert replies and all(r["read_secs"] > 0 for r in replies)
    assert reader.read(res["data"]) > 0
