"""Compare checkouts of the repository on one GPU: the f32 path of
``fused_point_mlp`` and the served ``bench_tiny`` mesh.

    python3 -m rgbd_pifuhd_tpu_torch.tools.ab_tiny ROOT [ROOT ...]

Each ROOT is the root of a checkout; give two as ``A B B A`` so that
drift of the card or the host shows as a difference between A's two runs.
For each ROOT, in the order given, two processes run inside that checkout
(its own package, kernels built into its own ``_build``; the server is
driven by this checkout's ``chip_smoke._Server``):

1. the f32 chain alone: ``fused_point_mlp`` on bench_tiny's fine MLP
   (48-64-32-1, trained weights) and on both full-width norm-free chains
   (``chip_smoke``'s seeded weights), N = 262,144 and 16,384; ms by CUDA
   events over 20 calls, and a hash of the output's bits;
2. ``cli.serve`` on bench_tiny as ``chip_smoke``'s served (b) runs it (the
   128^2 capsule as PNG, image colours + cleanup, PLY, 512^3): one cold
   request, then ``WARM`` warm ones, seconds from request line to reply.

Prints one JSON line per run and a last line with, for each chain, whether
every run gave the same bits.  Needs a CUDA card; every process it starts
ends before it returns.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WARM = 4

_CHAIN = r"""
import hashlib, json, os, sys
import torch
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
from rgbd_pifuhd_tpu_torch.models.mlp import PointMLP
from rgbd_pifuhd_tpu_torch.ops import fused_mlp as fm
fm.build()
dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
m32, _ = cs._tiny_fine_mlps(torch, PointMLP, dev)
chains = [("bench_tiny 48-64-32-1", m32)] + [
    (f"{name} {'-'.join(map(str, chans))}",
     cs._norm_free_mlp(torch, PointMLP, chans, res, torch.float32, dev, 5))
    for name, chans, res in cs.FULL_SHAPES]
gen = torch.Generator(device=dev)
out = {}
for label, m in chains:
    packed = m.packed()
    for N in (262144, 16384):
        gen.manual_seed(7)
        x = torch.randn((N, m.filter_channels[0]), generator=gen,
                        device=dev) * 0.7
        y = fm.fused_point_mlp(x, packed, res_layers=m.res_layers)
        torch.cuda.synchronize()
        bits = hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()[:16]
        ms = cs._event_ms(torch, lambda: fm.fused_point_mlp(
            x, packed, res_layers=m.res_layers), 20)
        out[f"{label} N={N}"] = {"ms": round(ms, 4), "bits": bits,
                                 "tile": fm.fused_point_mlp.last_block}
print(json.dumps(out))
"""


def _chain(root: str) -> dict:
    r = subprocess.run([sys.executable, "-c", _CHAIN], cwd=root,
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"{root}: chain timing exit {r.returncode}: "
                           f"{r.stderr[-2000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def _served(cs, root: str, req_dir: str, results: str, log_path: str) -> dict:
    srv = cs._Server(
        ["--load_netMR_checkpoint_path",
         os.path.join(root, "assets", "bench_tiny", "ckpt"),
         "--results_path", results, "--name", "b", "--resolution", "512",
         "--loadSize", "128", "--use_color", "2", "--mesh_format", "ply"],
        log_path, root=root)
    try:
        t0 = time.time()
        srv.read(1)
        ready_s = time.time() - t0
        req = f"{req_dir}::capsule"
        (cold,), cold_s = srv.ask(req)
        warm = [srv.ask(req) for _ in range(WARM)]
        srv.quit()
    finally:
        srv.kill()
    for r in [cold] + [w[0][0] for w in warm]:
        if "mesh" not in r:
            raise RuntimeError(f"{root}: server replied {r}; see {log_path}")
    return {"ready_s": round(ready_s, 3), "cold_s": round(cold_s, 3),
            "warm_s": [round(s, 3) for _, s in warm],
            "warm_server_secs": [r[0]["secs"] for r, _ in warm],
            "verts": cold["verts"]}


def main(argv=None) -> None:
    roots = [os.path.abspath(r) for r in (argv or sys.argv[1:])]
    if not roots:
        sys.exit(__doc__)
    import torch

    if not torch.cuda.is_available():
        sys.exit("ab_tiny needs a CUDA card")
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    out_dir = os.path.join(REPO, "smoke_out", "ab_tiny")
    req_dir = os.path.join(out_dir, "req")
    os.makedirs(out_dir, exist_ok=True)
    cs._write_subject(req_dir, "capsule", 128)
    runs = []
    for i, root in enumerate(roots):
        run = {"root": os.path.relpath(root, REPO), "chain": _chain(root),
               "served": _served(cs, root, req_dir,
                                 os.path.join(out_dir, f"res{i}"),
                                 os.path.join(out_dir, f"serve{i}.log"))}
        print(json.dumps(run), flush=True)
        runs.append(run)
    same = {k: len({r["chain"][k]["bits"] for r in runs}) == 1
            for k in runs[0]["chain"]}
    print(json.dumps({"same_bits_in_every_run": same}))


if __name__ == "__main__":
    main()
