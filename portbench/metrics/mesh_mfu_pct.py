"""Share of the bf16 peak that the traced meshes reach: (the encoders'
FLOPs per mesh, counted by ``FlopCounterMode`` on the reference at the
cell's shapes, times the meshes, plus the frozen per-point FLOPs times the
program's own ``points_queried``) over (the traced window times the peak).
A change that queries fewer points lowers it while ``mesh_s`` improves.
%."""

PEAK_BF16 = 989.4e12


def read(run):
    n, w = run.get("units", 0), run.get("window_s")
    enc = run.get("encode_flops")
    if not n or not w or enc is None:
        return None
    flop = enc * n + run["per_point_flops"] * run["points_queried"]
    return 100.0 * flop / (w * PEAK_BF16)
