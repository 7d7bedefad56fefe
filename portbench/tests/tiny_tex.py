"""The tiny texture cell for the CPU tests: ``tiny.py``'s two-level model
and 64^3 octree with a narrow netC (filter ngf 8, 2 blocks; colour chain
65-64-48-32-16-3, float32), the cell's own limits and traffic, its two
subjects in one directory request."""

from __future__ import annotations

from portbench.tests import tiny

C = dict(input_nc=3, ngf_color=8, n_blocks_color=2, norm_color="group",
         use_tanh=False, mlp_dim_color=[tiny.G["hg_dim"] + 33, 64, 48, 32, 16,
                                        3],
         mlp_res_layers=[1, 2, 3, 4], last_op="tanh", compute_dtype="float32")


def tex_cell(ckpt: str, workload: str = "texpifu-serve-512") -> dict:
    traffic = tiny._json("portbench", "traffic", "serve-tex.json")
    # one directory request of both subjects: on the CPU a tiny mesh
    # takes tens of seconds, and both checked meshes are in the first one
    traffic = dict(traffic, pool=[["sphere", 1], ["capsule", 1]],
                   request="directory",
                   server_args=["--resolution", "64", "--use_color", "3"])
    return {"workload": {"name": workload, "chips": 1},
            "config": {"checkpoint": ckpt, "netG": tiny.G, "netMR": tiny.L,
                       "netC": C},
            "traffic": traffic,
            "limits": tiny._json("portbench", "limits", workload + ".json")}
