"""Share of the bf16 peak that the traced textured meshes reach:
``mesh_mfu_pct``'s FLOPs (the encoders' per mesh by ``FlopCounterMode`` on
the reference, plus the field's frozen per-point FLOPs times the program's
``points_queried``) plus netC's: its filter's FLOPs per mesh (on the
reference) and the colour chain's frozen per-point FLOPs times the
program's ``color_points``; over the traced window times the peak.  %."""

PEAK_BF16 = 989.4e12


def read(run):
    n, w = run.get("units", 0), run.get("window_s")
    enc, tex = run.get("encode_flops"), run.get("tex_encode_flops")
    if not n or not w or enc is None or tex is None \
            or run.get("color_points") is None:
        return None
    flop = ((enc + tex) * n + run["per_point_flops"] * run["points_queried"]
            + run["color_flops_per_point"] * run["color_points"])
    return 100.0 * flop / (w * PEAK_BF16)
