"""What both entry points share: loading a checkpoint into a
``Reconstructor``, reading a subject, naming its mesh file, and the kernel
launch counters they report."""

from __future__ import annotations

import os

from ..models.multires import MultiResPIFu
from ..ops.fused_mlp import fused_point_mlp
from ..ops.fused_query import fused_gather_mlp, gather_concat
from ..recon.pipeline import Reconstructor
from ..utils import checkpoint as ckpt
from ..utils.device import resolve_device
from ..utils.options import Options


def latest_path(checkpoints_path: str, name: str) -> str:
    return os.path.join(checkpoints_path, f"{name}_train_latest")


def load_reconstructor(opt: Options, device: str, full_opts: bool = False):
    """Checkpoint named by ``opt`` -> ``(Reconstructor, model options,
    checkpoint path)``.  ``full_opts`` takes every option the checkpoint
    embeds (the trained demo); otherwise the command line keeps the run's
    fields (``Options.restore_from_checkpoint_dict``)."""
    dev = resolve_device(device)
    path = opt.load_netMR_checkpoint_path or latest_path(
        opt.checkpoints_path, opt.name)
    if not os.path.exists(path):
        raise SystemExit(f"checkpoint not found: {path}")
    state = ckpt.load_checkpoint(path, device=dev)
    if state.get("torch_import"):
        raise SystemExit(f"{path}: checkpoints imported from a reference "
                         ".pth file are not supported yet")
    if full_opts:
        opt_model = Options.from_dict(state["opt"])
    else:
        opt_model, _ = ckpt.restore_options(opt, state)
    model = MultiResPIFu(opt_model.netMR, opt_model.netG, device=dev)
    ckpt.load_params(model, state["params"])
    return Reconstructor(model, opt_model, device=dev), opt_model, path


def load_item(dataset, i: int) -> dict:
    data = dict(dataset[i])
    if data["img_512"].ndim == 3:
        data["img_512"] = data["img_512"][None]
    return data


def mesh_path(out_dir: str, data: dict, opt: Options) -> str:
    ext = getattr(opt, "mesh_format", "obj")
    return os.path.join(out_dir,
                        f"result_{data['name']}_{opt.resolution}.{ext}")


def launch_counts(recon: Reconstructor) -> dict:
    """Kernel launches of this process and the field queries behind them
    (each query is one coarse-level and one fine-level kernel call)."""
    return {"query_calls": recon.total_query_calls,
            "fused_gather_mlp": fused_gather_mlp.launches,
            "fused_point_mlp": fused_point_mlp.launches,
            "gather_concat": gather_concat.launches}
