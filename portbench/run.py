"""Benchmark of ``rgbd_pifuhd_tpu_torch`` on NVIDIA GPUs: one run of one
cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``workloads`` in ``BENCHMARK.json``) names a configuration
(``configs``: its file of sizes) and a traffic mix
(``portbench/traffic/<traffic>.json``, whose ``entry`` names the module
in ``portbench/entries/`` that drives the program's entry point); its
limits are ``portbench/limits/<workload>.json``; each per-layer metric
is read by ``portbench/metrics/<metric>.py``.  All of them are found by
name: a cell, a mix, a configuration or a metric is added as files and
entries.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``compared``: each number the
correctness check compared, with its limit.  The same numbers end standard
error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "rgbd_pifuhd_tpu")


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(bench: dict, workload: str) -> dict:
    """The cell's workload entry, configuration entry and files."""
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    with open(os.path.join(ROOT, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", wl["traffic"] + ".json")) as f:
        traffic = json.load(f)
    with open(os.path.join(HERE, "limits", workload + ".json")) as f:
        limits = json.load(f)
    return {"workload": wl, "config": config, "traffic": traffic,
            "limits": limits}


def metrics_of(bench: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of the cell prints."""
    if not trace:
        return [m for m in bench["end_to_end"]
                if workload in m.get("workloads", [workload])]
    e2e = {m["name"] for m in metrics_of(bench, workload, False)}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload])
            and m["moves"] in e2e]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def run_cell(c: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", workdir: str | None = None,
             t_start: float = T_START, control: bool = False) -> dict:
    """One run: the entry's result plus the metrics' readings and the
    verdict.  ``device='cpu'`` and ``control`` serve the tests."""
    from portbench.trace import Tracer

    entry = load_module(os.path.join(HERE, "entries",
                                     c["traffic"]["entry"] + ".py"),
                        "portbench_entry_" + c["traffic"]["entry"])
    tracer = Tracer(trace and device == "cuda")
    # a run that outstays its time says where each thread was
    faulthandler.dump_traceback_later(330, exit=False)
    own = workdir is None
    work = tempfile.mkdtemp(prefix="portbench_") if own else workdir
    try:
        res = entry.run({"config": c["config"], "traffic": c["traffic"],
                         "seed": seed, "seconds": seconds, "trace": trace,
                         "tracer": tracer, "device": device, "root": ROOT,
                         "workdir": work, "control": control})
    finally:
        faulthandler.cancel_dump_traceback_later()
        if own:
            import shutil

            shutil.rmtree(work, ignore_errors=True)
    res["setup_s"] = res["t_window"] - t_start
    compared = {}
    ok = res["failed"] == 0 and res["attempted"] > 0
    for name, limit in c["limits"].items():
        v = res["numbers"].get(name)
        compared[name] = {"value": v, "limit": limit}
        ok = ok and v is not None and v <= limit
    res["correct"] = bool(ok)
    res["compared"] = compared
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # a run stopped from outside says where it was
    faulthandler.register(signal.SIGTERM, chain=True)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_TF", "0")
    sys.path.insert(0, ROOT)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    c = cell(bench, args.workload)
    import torch

    chips = c["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    card = card_line()
    res = run_cell(c, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    wanted = metrics_of(bench, args.workload, bool(args.trace))
    metrics = {}
    if not args.trace:
        vals = dict(res["e2e"], setup_s=res["setup_s"])
        for m in wanted:
            metrics[m["name"]] = {"value": vals[m["name"]], "unit": m["unit"]}
    else:
        run = {**res["data"], "trace": res["trace"],
               "window_s": res["window_s"], "e2e": res["e2e"],
               "config": c["config"], "traffic": c["traffic"]}
        for m in wanted:
            reader = load_module(os.path.join(HERE, "metrics",
                                              m["name"] + ".py"),
                                 "portbench_metric_" + m["name"])
            v = reader.read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": res["memory_peak_bytes"]}
    out = {"correct": res["correct"], "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": device,
           "card": card}
    if args.trace:
        t = res["trace"]
        device["busy_s"] = t["busy_s"]
        device["window_s"] = res["window_s"]
        out["breakdown"] = {"device_ops": t["device_ops"],
                            "idle_gaps": t["idle_gaps"]}
    info = {k: v for k, v in res["numbers"].items()
            if k not in res["compared"]}
    print(f"card: {card}; peaks 989.4 TFLOP/s bf16, 3.35 TB/s; "
          f"other readings {json.dumps(info)}", file=sys.stderr)
    if args.trace:
        t = res["trace"]
        print(f"trace: {t['ops']} device operations, {t['unmatched']} "
              f"without their launch; launches {t.get('runtime_calls')}; "
              f"device s by span {t['span_device_s']}", file=sys.stderr)
    for k, v in res["compared"].items():
        print(f"compared {k} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    out["compared"] = res["compared"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
