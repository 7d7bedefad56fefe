"""Device ms per mesh of the kernels launched inside the benchmark's
``pb.color`` spans (netC's filter and attach, each colour dispatch) and
``pb.color_query`` spans (each colour query), from the trace."""


def read(run):
    t, n = run.get("trace"), run.get("units", 0)
    by = (t or {}).get("span_device_s", {})
    s = by.get("pb.color", 0.0) + by.get("pb.color_query", 0.0)
    return 1e3 * s / n if s and n else None
