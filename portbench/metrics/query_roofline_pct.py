"""Share of the field queries' device time that the chip's roofline needs:
the sum over every query call (``query``, ``field_last``,
``calc_normal``) of max(FLOPs / bf16 peak, bytes / bandwidth), FLOPs the
frozen per-point count times the call's points, bytes each input read once
and each output written once; over the device time of the kernels launched
inside those calls' ``pb.query`` spans.  %."""


def read(run):
    t = run.get("trace") or {}
    dev = t.get("span_device_s", {}).get("pb.query")
    least = run.get("least_query_s")
    return 100.0 * least / dev if dev and least else None
