"""Share of the colour queries' device time that the chip's roofline
needs: max(FLOPs / bf16 peak, bytes / bandwidth), FLOPs the colour chain's
frozen per-point count times the program's ``color_points`` (the window's
vertices coloured by the texture field), bytes each call's map and weights
once plus each point's own; over the device time of the kernels launched
inside the ``pb.color_query`` spans.  %."""

PEAK_BF16 = 989.4e12
PEAK_BYTES = 3.35e12


def read(run):
    t = run.get("trace") or {}
    dev = t.get("span_device_s", {}).get("pb.color_query")
    n = run.get("color_points")
    if not dev or not n or run.get("color_flops_per_point") is None:
        return None
    flop = run["color_flops_per_point"] * n
    byts = (run["color_call_bytes"] * run.get("color_calls", 0)
            + run["color_point_bytes"] * n)
    return 100.0 * max(flop / PEAK_BF16, byts / PEAK_BYTES) / dev
