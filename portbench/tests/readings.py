"""Readings of the correctness check for its limits, on the card: the
program's numbers on each seed, and with ``--control`` the control's (the
reference one precision lower in the program's place), in one process.

    python3 portbench/tests/readings.py <workload> <seconds> <seed>... \\
        [--control] [--fault <name>]

``--fault`` plants one of ``faults.py``'s faults first.  Prints one JSON
line a seed: ``{"seed", "control", "fault", "numbers", "correct", ...}``.
"""

from __future__ import annotations

import faulthandler
import json
import os
import signal
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from portbench import run as R  # noqa: E402


def main(argv) -> None:
    faulthandler.register(signal.SIGTERM, chain=True)
    control = "--control" in argv
    args = [a for a in argv if a != "--control"]
    fault = None
    if "--fault" in args:
        i = args.index("--fault")
        fault = args[i + 1]
        del args[i:i + 2]
        from portbench.tests import faults
        faults.apply(fault)
    workload, seconds, seeds = args[0], float(args[1]), args[2:]
    with open(os.path.join(R.ROOT, "BENCHMARK.json")) as f:
        c = R.cell(json.load(f), workload)
    for s in seeds:
        t = time.perf_counter()
        res = R.run_cell(c, int(s), seconds, False, t_start=t,
                         control=control)
        print(json.dumps({"seed": int(s), "control": control,
                          "fault": fault,
                          "numbers": res["numbers"],
                          "correct": res["correct"],
                          "e2e": res["e2e"], "failed": res["failed"],
                          "attempted": res["attempted"],
                          "setup_s": res["setup_s"]}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
