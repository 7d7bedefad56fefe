"""FLOPs of one step (forward and backward, counted once by
``FlopCounterMode`` on the reference at the cell's shapes) over the traced
run's step time times the bf16 peak, %."""

PEAK_BF16 = 989.4e12


def read(run):
    f, ms = run.get("step_flops"), run.get("e2e", {}).get("train_step_ms")
    return 100.0 * f / (ms * 1e-3 * PEAK_BF16) if f and ms else None
