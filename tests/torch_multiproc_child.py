"""Child worker of ``tests/test_torch_multiproc.py`` (not collected by
pytest).  It imports torch, NumPy and the port only.

Two of these join a gloo process group on localhost (one CPU device each)
and, with ``parallel.shard_host_batch`` + ``train.trainers.
shard_train_step``, take 3 data-parallel fine steps of the tiny
batch-norm model on the global batch of 8 (each rank 4 items); then run
one two-level grid query whose point axis spans both processes (4 CPU
shards a rank, 8 in all).  Rank 0 writes the losses and the volume.

Usage: python torch_multiproc_child.py <port> <process_id> <out.npz>
"""

import os
import sys


def bn_configs():
    """The tiny flagship-shaped pair of ``__graft_entry__._configs(tiny=
    True)`` with ``norm='batch'`` (``tests/multihost_child.py``), as the
    port's configs: ``(global, local)``."""
    from rgbd_pifuhd_tpu_torch.utils.options import PIFuLevelConfig

    g = PIFuLevelConfig(
        num_stack=2, hg_depth=1, hg_dim=8, norm="batch",
        hg_down="ave_pool", mlp_dim=(9, 64, 32, 16, 1),
        mlp_res_layers=(1,), mlp_norm="none", merge_layer=2,
        use_front_normal=True, use_back_normal=True,
        nml_ngf=8, nml_n_downsampling=2, nml_n_blocks=1, load_size=64)
    l = PIFuLevelConfig(
        num_stack=1, hg_depth=1, hg_dim=4, norm="batch",
        hg_down="no_down", mlp_dim=(20, 32, 16, 1),
        mlp_res_layers=(1,), mlp_norm="none", merge_layer=-1,
        use_front_normal=False, use_back_normal=False, load_size=64)
    return g, l


def example_batch(seed: int = 7, B1: int = 8, B2: int = 2, N: int = 64,
                  res_g: int = 64, res_l: int = 32) -> dict:
    """``__graft_entry__._example_batch(default_rng(seed), ...)`` in
    NumPy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {
        "images_local": rng.standard_normal(
            (B1, B2, res_l, res_l, 6)).astype(f32),
        "images_global": rng.standard_normal(
            (B1, res_g, res_g, 6)).astype(f32),
        "points": rng.uniform(-0.9, 0.9, (B1, B2, N, 3)).astype(f32),
        "calib_local": np.tile(np.eye(4, dtype=f32)[None, None],
                               (B1, B2, 1, 1)),
        "calib_global": np.tile(np.eye(4, dtype=f32)[None], (B1, 1, 1)),
        "labels": (rng.uniform(0, 1, (B1, B2, N, 1)) > 0.5).astype(f32),
    }


def build_model():
    """The batch-norm pair, drawn by the port's ``init_flax`` (seed 0)."""
    import torch

    from rgbd_pifuhd_tpu_torch.models import MultiResPIFu
    from rgbd_pifuhd_tpu_torch.models.blocks import init_flax

    g, l = bn_configs()
    model = MultiResPIFu(l, g, device="cpu")
    init_flax(model, torch.Generator().manual_seed(0))
    return model


def train_steps(model, batch: dict, mesh=None, n_steps: int = 3) -> list:
    """``n_steps`` fine steps (rmsprop 1e-3) on ``batch``; with a mesh
    each rank keeps its rows and the step is ``shard_train_step``'s."""
    import torch

    from rgbd_pifuhd_tpu_torch.parallel import shard_host_batch
    from rgbd_pifuhd_tpu_torch.train.trainers import (
        make_fine_train_step, make_optimizer, shard_train_step)

    step = make_fine_train_step(
        model, make_optimizer("rmsprop", 1e-3, model.parameters()))
    if mesh is not None:
        step = shard_train_step(step, mesh)
        batch = shard_host_batch(mesh, batch)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return [float(step(batch)["loss"]) for _ in range(n_steps)]


def grid_query(model, batch: dict, mesh=None):
    """One two-level grid evaluation (16^3, factor 4) of the first item,
    the point axis sharded over ``mesh``; the dense volume."""
    import torch

    from rgbd_pifuhd_tpu_torch.parallel import shard_points_query
    from rgbd_pifuhd_tpu_torch.recon.grid import eval_grid_two_phase

    def query(world_pts, l_feats, g_feats, calib):
        return model.query(l_feats, g_feats, world_pts[None, None],
                           calib[None, None], calib[None]).preds[0, :, 0]

    with torch.no_grad():
        g_feats = model.filter_global(
            torch.from_numpy(batch["images_global"][:1]))
        l_feats = model.filter_local(
            torch.from_numpy(batch["images_local"][:1, :1]), g_feats)
        q = shard_points_query(query, mesh) if mesh is not None else query
        vol, _ = eval_grid_two_phase(q, 16, torch.eye(4), l_feats, g_feats,
                                     torch.eye(4), factor=4, budget_cells=16,
                                     cells_per_chunk=16)
    return vol.numpy()


def main():
    port, pid, out_path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    import numpy as np
    import torch.distributed as dist

    from rgbd_pifuhd_tpu_torch.parallel import (
        initialize_distributed, is_primary, make_device_mesh)

    assert initialize_distributed(f"127.0.0.1:{port}", 2, pid,
                                  device="cpu")
    try:
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 2
        mesh = make_device_mesh(devices=["cpu"])
        assert mesh.size == 2 and mesh.rank == pid
        batch = example_batch()
        losses = train_steps(build_model(), batch, mesh)
        mesh8 = make_device_mesh(devices=["cpu"] * 4)
        assert mesh8.size == 8 and len(mesh8.local_devices) == 4
        vol = grid_query(build_model().eval(), batch, mesh8)
        if is_primary():
            np.savez(out_path, losses=np.asarray(losses, np.float64),
                     vol=vol)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
