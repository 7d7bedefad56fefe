"""Tiny cells for the CPU tests: the harness's entries on a two-stack,
narrow model (the hourglass trunk keeps its fixed 64-256 channels) and a
64^3 octree, with the limits of the cell they stand for."""

from __future__ import annotations

import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

G = dict(num_stack=2, hg_depth=1, hg_dim=32, norm="group",
         hg_down="ave_pool", mlp_dim=[33, 64, 32, 1], mlp_res_layers=[1],
         mlp_norm="group", merge_layer=1, use_rgb=True, use_depth=True,
         use_front_normal=True, use_back_normal=True, nml_ngf=4,
         nml_n_downsampling=2, nml_n_blocks=1, load_size=1024, z_size=200.0,
         projection_mode="orthogonal", compute_dtype="float32")
L = dict(G, num_stack=1, hg_dim=8, mlp_dim=[40, 64, 32, 1], merge_layer=-1,
         use_front_normal=False, use_back_normal=False)


def _json(*p):
    with open(os.path.join(ROOT, *p)) as f:
        return json.load(f)


def checkpoint(path: str, seed: int = 0) -> None:
    """A seeded tiny two-level checkpoint in the program's format."""
    import torch

    from rgbd_pifuhd_tpu_torch.models.blocks import init_flax
    from rgbd_pifuhd_tpu_torch.models.multires import MultiResPIFu
    from rgbd_pifuhd_tpu_torch.utils import checkpoint as ck
    from rgbd_pifuhd_tpu_torch.utils.options import Options, PIFuLevelConfig

    def lv(d):
        return PIFuLevelConfig(**{k: tuple(v) if isinstance(v, list) else v
                                  for k, v in d.items()})

    m = MultiResPIFu(lv(L), lv(G), device="cpu")
    init_flax(m, torch.Generator().manual_seed(seed))
    opt = Options(netG=lv(G), netMR=lv(L))
    ck.save_checkpoint(path, ck.params_to_flax(m), opt, opt_netG=opt)


def serve_cell(ckpt: str, workload: str = "lite-serve-fd") -> dict:
    traffic = _json("portbench", "traffic",
                    "serve-fd.json" if "serve" in workload
                    else "batch-fd.json")
    traffic = dict(traffic, pool=[["sphere", 1], ["capsule", 1]],
                   server_args=["--resolution", "64", "--use_color", "0"])
    return {"workload": {"name": workload, "chips": 1},
            "config": {"checkpoint": ckpt, "netG": G, "netMR": L},
            "traffic": traffic,
            "limits": _json("portbench", "limits", workload + ".json")}


def train_cell(workload: str = "flagship-train-coarse") -> dict:
    traffic = _json("portbench", "traffic", "train-coarse.json")
    traffic["tree"] = dict(traffic["tree"], images_per_subject=1)
    # the configuration's 4,096 points: at 512 the tiny float32 cell's
    # change over three steps read 0.008 on one of its two batch draws
    cfg = dict(_json("portbench", "configs", "pifuhd-flagship.json"),
               netG=G, netMR=L)
    return {"workload": {"name": workload, "chips": 1}, "config": cfg,
            "traffic": traffic,
            "limits": _json("portbench", "limits", workload + ".json")}

