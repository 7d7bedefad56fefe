"""Training-tree generation (port of ``cli/gen_data.py``), host code:

    python3 -m rgbd_pifuhd_tpu_torch.cli.gen_data --out ./traindata
    python3 -m rgbd_pifuhd_tpu_torch.cli.gen_data --out ./traindata \\
        --obj_dir ./subjects [--use_prt] [--yaw_step 4] [--backgrounds DIR]

Without ``--obj_dir`` it writes the analytic subjects
(``data.synthetic.generate_synthetic_dataset``).  With it, every ``.obj``
there is rendered into the tree (``data.render_dataset``) and its front
view composited over the backgrounds into ``gen/`` (``data.composite``);
a second line then gives the seconds spent loading, on PRT, rasterising
and encoding, and in all, as JSON.
"""

from __future__ import annotations

import argparse
import json
import time

from ..data.synthetic import generate_synthetic_dataset


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--load_size", type=int, default=1024)
    p.add_argument("--subjects", nargs="+", default=["sphere", "capsule"])
    p.add_argument("--obj_dir", default=None,
                   help="render real OBJ subjects instead of analytic ones")
    p.add_argument("--yaw_step", type=int, default=180,
                   help="4 renders the full 90-view sweep")
    p.add_argument("--use_prt", action="store_true",
                   help="SH/PRT diffuse shading (slower)")
    p.add_argument("--backgrounds", default=None,
                   help="background image dir for gen/ composites")
    args = p.parse_args(argv)

    if args.obj_dir:
        from ..data.composite import composite_over_backgrounds
        from ..data.render_dataset import render_dataset

        t0 = time.perf_counter()
        timings: dict = {}
        views = render_dataset(args.out, args.obj_dir, args.size,
                               args.load_size, args.yaw_step, args.use_prt,
                               timings=timings)
        t1 = time.perf_counter()
        composite_over_backgrounds(args.out, args.backgrounds)
        timings["composite"] = time.perf_counter() - t1
        timings["total"] = time.perf_counter() - t0
        print(f"rendered {views} into {args.out}")
        print(json.dumps({"seconds": timings}))
    else:
        generate_synthetic_dataset(args.out, tuple(args.subjects), args.size,
                                   args.load_size)
        print(f"wrote synthetic dataset to {args.out}")


if __name__ == "__main__":
    main()
