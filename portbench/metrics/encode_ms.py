"""Device ms per mesh of the kernels launched inside the benchmark's
``pb.encode`` spans (around ``Reconstructor.encode``), from the trace."""


def read(run):
    t, n = run.get("trace"), run.get("units", 0)
    s = (t or {}).get("span_device_s", {}).get("pb.encode")
    return 1e3 * s / n if s and n else None
