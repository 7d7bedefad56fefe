"""Spreads of end-to-end metrics over sets of runs, as the bounds are set
from them: for each set, the distance between the first and third
quartiles (``statistics.quantiles(values, n=4)``) over the median.

    python3 portbench/tests/spreads.py <result lines file>...

Each file holds one set: the last JSON lines of the runs' standard output
(one a run).  Prints each metric's medians and spreads by set.
"""

from __future__ import annotations

import json
import statistics
import sys


def spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(paths) -> None:
    for p in paths:
        rows = [json.loads(x) for x in open(p) if x.startswith("{")]
        keys = sorted({k for r in rows for k in r["metrics"]})
        print(p, f"{len(rows)} runs, correct {[r['correct'] for r in rows]}")
        for k in keys:
            v = [r["metrics"][k]["value"] for r in rows if k in r["metrics"]]
            print(f"  {k}: median {statistics.median(v):.6g} spread "
                  f"{spread(v):.4f} values {[round(x, 4) for x in v]}")


if __name__ == "__main__":
    main(sys.argv[1:])
