"""Share of the traced window in which no kernel, copy or memset ran on
the device (torch.profiler's CUDA activity), %."""


def read(run):
    t, w = run.get("trace"), run.get("window_s")
    if not t or not w or not t.get("ops"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / w)
