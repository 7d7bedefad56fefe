"""Configuration dataclasses (a copy of ``rgbd_pifuhd_tpu.utils.options``).

Checkpoints embed ``Options.to_dict()``; ``from_dict`` restores them;
``parse_options`` is the command line of the entry points (the JAX package's
flags plus ``--device`` and ``--freq_save``).
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import Sequence


@dataclass
class PIFuLevelConfig:
    """Per-level (coarse/global or fine/local) model configuration."""

    num_stack: int = 4
    hg_depth: int = 2
    hg_dim: int = 256
    norm: str = "group"
    hg_down: str = "ave_pool"
    mlp_dim: tuple = (257, 1024, 512, 256, 128, 1)
    mlp_res_layers: tuple = (2, 3, 4)
    mlp_norm: str = "group"
    merge_layer: int = 2
    use_rgb: bool = True
    use_depth: bool = True
    use_front_normal: bool = True
    use_back_normal: bool = True
    nml_ngf: int = 64
    nml_n_downsampling: int = 4
    nml_n_blocks: int = 9
    load_size: int = 1024
    z_size: float = 200.0
    projection_mode: str = "orthogonal"
    # activation compute dtype ('float32' | 'bfloat16'); params stay f32
    compute_dtype: str = "float32"
    remat: bool = False

    @property
    def in_channels(self) -> int:
        return 3 * (int(self.use_rgb) + int(self.use_depth)
                    + int(self.use_front_normal) + int(self.use_back_normal))

    @property
    def normal_input_channels(self) -> int:
        """netF/netB input = RGB (+depth): the 6-channel RGB-D stack."""
        return 3 * (int(self.use_rgb) + int(self.use_depth))


@dataclass
class ColorConfig:
    """Sizes of PIFu's texture network (netC, ``models.texture``) under
    PIFu's option names where it has them (``lib/options.py``:
    ``mlp_dim_color``, ``norm_color``); the ``ResnetFilter``'s width and
    blocks are ``ResBlkPIFuNet``'s fixed ``ngf=64``, ``n_blocks=6``.  A
    checkpoint that holds a netC embeds them as ``opt_netC``."""

    mlp_dim_color: tuple = (513, 1024, 512, 256, 128, 3)
    norm_color: str = "group"
    ngf_color: int = 64
    n_blocks_color: int = 6
    compute_dtype: str = "float32"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ColorConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in d.items() if k in known})


def default_global_config() -> PIFuLevelConfig:
    return PIFuLevelConfig(
        num_stack=4, hg_depth=2, hg_dim=256, hg_down="ave_pool",
        mlp_dim=(257, 1024, 512, 256, 128, 1), mlp_res_layers=(2, 3, 4),
        merge_layer=2, load_size=1024,
    )


def default_local_config() -> PIFuLevelConfig:
    return PIFuLevelConfig(
        num_stack=1, hg_depth=2, hg_dim=16, hg_down="no_down",
        mlp_dim=(272, 512, 256, 128, 1), mlp_res_layers=(1, 2),
        merge_layer=-1, load_size=1024,
    )


@dataclass
class Options:
    """Full experiment configuration (the JAX package's ``Options``)."""

    dataset: str = "renderppl"
    dataroot: str = "./data"
    load_size: int = 1024
    load_size_big: int = 1024
    load_size_local: int = 512

    name: str = "pifuhd"
    debug: bool = False
    mode: str = "inout"

    batch_size: int = 1
    num_threads: int = 4
    serial_batches: bool = False
    learning_rate: float = 1e-3
    num_iter: int = 30
    num_epoch: int = 1
    freq_plot: int = 100
    freq_save: int = 5
    freq_show: int = 1
    resume_epoch: int = -1
    continue_train: bool = False
    train_full_pifu: bool = False
    schedule: tuple = (10, 15)
    gamma: float = 0.1
    occ_loss_type: str = "bce"
    optimizer: str = "rmsprop"
    seed: int = 0

    resolution: int = 512
    start_id: int = -1
    end_id: int = -1
    use_color: int = 0
    use_compose: bool = False
    use_octree: bool = True
    num_samples_query: int = 262144
    num_refine_cells: int = 12288
    octree_levels: int = 3
    num_refine_subcells: int = 32768
    auto_escalate_budget: bool = True
    mesh_format: str = "obj"
    normal_mode: str = "fd"
    marching_algo: str = "mc"
    streamed_recon: bool = True

    num_sample_inout: int = 300
    sigma: float = 1.0
    sigma_max: float = 0.0
    sigma_min: float = 0.0
    z_size: float = 200.0
    uniform_ratio: float = 0.1

    netG: PIFuLevelConfig = field(default_factory=default_global_config)
    netMR: PIFuLevelConfig = field(default_factory=default_local_config)
    num_local: int = 1

    checkpoints_path: str = "./checkpoints"
    results_path: str = "./result"
    load_netG_checkpoint_path: str | None = None
    load_netMR_checkpoint_path: str | None = None

    mesh_shape: tuple = (-1,)
    dtype: str = "bfloat16"

    use_aug: bool = False
    aug_bri: float = 0.2
    aug_con: float = 0.2
    aug_sat: float = 0.05
    aug_hue: float = 0.05
    aug_blur: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Options":
        d = dict(d)
        for key in ("netG", "netMR"):
            if key in d and isinstance(d[key], dict):
                sub = {k: tuple(v) if isinstance(v, list) else v
                       for k, v in d[key].items()}
                d[key] = PIFuLevelConfig(**sub)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in d.items() if k in known})

    def restore_from_checkpoint_dict(self, d: dict) -> "Options":
        """Checkpointed opts override everything except the run's data
        root, resolution, output paths and export preferences."""
        keep = {k: getattr(self, k) for k in (
            "dataroot", "resolution", "results_path", "load_size",
            "mesh_format", "normal_mode", "marching_algo")}
        restored = Options.from_dict(d)
        for k, v in keep.items():
            setattr(restored, k, v)
        return restored


def build_arg_parser() -> argparse.ArgumentParser:
    """Argparse bridge with the JAX package's flag names, plus
    ``--device`` (``cuda`` unless the caller asks for ``cpu``)."""
    p = argparse.ArgumentParser(
        description="rgbd_pifuhd_tpu_torch",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    # Data
    p.add_argument("--dataset", type=str, default="renderppl")
    p.add_argument("--dataroot", type=str, default="./data")
    p.add_argument("--loadSize", type=int, default=1024)
    p.add_argument("--loadSizeBig", type=int, default=1024)
    p.add_argument("--loadSizeLocal", type=int, default=512)
    # Experiment
    p.add_argument("--name", type=str, default="pifuhd")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--mode", type=str, default="inout")
    # Training
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--num_threads", type=int, default=4)
    p.add_argument("--serial_batches", action="store_true")
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--num_iter", type=int, default=30)
    p.add_argument("--num_epoch", type=int, default=1)
    p.add_argument("--freq_save", type=int, default=5,
                   help="write <name>_train_epoch_<N> when N % freq_save "
                        "is 0 (latest is written every epoch)")
    p.add_argument("--resume_epoch", type=int, default=-1)
    p.add_argument("--continue_train", action="store_true")
    p.add_argument("--train_full_pifu", action="store_true")
    p.add_argument("--schedule", type=int, nargs="+", default=[10, 15])
    p.add_argument("--gamma", type=float, default=0.1)
    p.add_argument("--occ_loss_type", type=str, default="bce")
    p.add_argument("--optimizer", type=str, default="rmsprop")
    p.add_argument("--seed", type=int, default=0)
    # Testing / recon
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--start_id", type=int, default=-1)
    p.add_argument("--end_id", type=int, default=-1)
    p.add_argument("--use_color", type=int, default=0)
    p.add_argument("--no_octree", action="store_true")
    p.add_argument("--octree_levels", type=int, default=3, choices=(2, 3),
                   help="3 = stride 8->4->1 refinement, 2 = single split")
    p.add_argument("--num_refine_subcells", type=int, default=32768,
                   help="level-3 refinement budget (4^3 sub-cells)")
    p.add_argument("--num_refine_cells", type=int, default=12288,
                   help="two-phase refinement budget (cells of 8^3 voxels)")
    p.add_argument("--no_auto_escalate_budget", action="store_true",
                   help="disable budget doubling on refinement overflow")
    p.add_argument("--marching_algo", type=str, default="mc",
                   choices=("mc", "mt"),
                   help="isosurface extractor: watertight marching cubes "
                        "(~3x fewer verts/tris) or marching tetrahedra")
    p.add_argument("--no_streamed_recon", action="store_true",
                   help="disable band-streamed reconstruction (one-shot "
                        "field transfer, then slab-incremental marching)")
    p.add_argument("--normal_mode", type=str, default="fd",
                   choices=("fd", "grad", "mesh"),
                   help="vertex normals: 4-tap finite difference (reference"
                        " semantics), one autodiff sweep (exact field "
                        "gradient), or geometric mesh normals (no device "
                        "color pass — fastest)")
    p.add_argument("--mesh_format", type=str, default="obj",
                   choices=("obj", "ply"),
                   help="mesh export: text OBJ (reference parity) or "
                        "binary PLY (much faster host write)")
    # Sampling
    p.add_argument("--num_sample_inout", type=int, default=300)
    p.add_argument("--sigma", type=float, default=1.0)
    p.add_argument("--sigma_max", type=float, default=0.0)
    p.add_argument("--sigma_min", type=float, default=0.0)
    p.add_argument("--z_size", type=float, default=200.0)
    # Model — global
    p.add_argument("--norm", type=str, default="group")
    p.add_argument("--num_stack_global", type=int, default=4)
    p.add_argument("--hg_depth_global", type=int, default=2)
    p.add_argument("--hg_dim_global", type=int, default=256)
    p.add_argument("--mlp_dim_global", type=int, nargs="+",
                   default=[257, 1024, 512, 256, 128, 1])
    p.add_argument("--mlp_res_layers_global", type=int, nargs="+",
                   default=[2, 3, 4])
    # Model — local
    p.add_argument("--num_stack_local", type=int, default=1)
    p.add_argument("--hg_depth_local", type=int, default=2)
    p.add_argument("--hg_dim_local", type=int, default=16)
    p.add_argument("--mlp_dim_local", type=int, nargs="+",
                   default=[272, 512, 256, 128, 1])
    p.add_argument("--mlp_res_layers_local", type=int, nargs="+",
                   default=[1, 2])
    p.add_argument("--mlp_norm", type=str, default="group")
    p.add_argument("--merge_layer", type=int, default=2)
    p.add_argument("--num_local", type=int, default=1)
    # Normal conditioning
    p.add_argument("--use_front_normal", action="store_true", default=True)
    p.add_argument("--use_back_normal", action="store_true", default=True)
    p.add_argument("--no_front_normal", action="store_true")
    p.add_argument("--no_back_normal", action="store_true")
    p.add_argument("--no_depth", action="store_true")
    # Paths
    p.add_argument("--checkpoints_path", type=str, default="./checkpoints")
    p.add_argument("--results_path", type=str, default="./result")
    p.add_argument("--load_netG_checkpoint_path", type=str, default=None)
    p.add_argument("--load_netMR_checkpoint_path", type=str, default=None)
    # Parallelism / numerics (new)
    p.add_argument("--mesh_shape", type=int, nargs="+", default=[-1])
    p.add_argument("--dtype", type=str, default="bfloat16")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   help="activation dtype for convs/MLP (bfloat16|float32)")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize hourglass stacks (training memory)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the entry point; without a CUDA "
                        "device the default raises instead of running on "
                        "the CPU")
    # Aug
    p.add_argument("--use_aug", action="store_true",
                   help="enable color-jitter augmentation (aug_* flags)")
    p.add_argument("--aug_bri", type=float, default=0.2)
    p.add_argument("--aug_con", type=float, default=0.2)
    p.add_argument("--aug_sat", type=float, default=0.05)
    p.add_argument("--aug_hue", type=float, default=0.05)
    p.add_argument("--aug_blur", type=float, default=0.0)
    return p


def parse_options(argv: Sequence[str] | None = None,
                  with_device: bool = False):
    """Command line -> ``Options`` (and the ``--device`` string when
    ``with_device``: the device is the process's, not the experiment's, so
    it is no field of ``Options``)."""
    args = build_arg_parser().parse_args(argv)
    use_f = args.use_front_normal and not args.no_front_normal
    use_b = args.use_back_normal and not args.no_back_normal
    use_d = not args.no_depth

    netG = PIFuLevelConfig(
        num_stack=args.num_stack_global, hg_depth=args.hg_depth_global,
        hg_dim=args.hg_dim_global, norm=args.norm, hg_down="ave_pool",
        mlp_dim=tuple(args.mlp_dim_global),
        mlp_res_layers=tuple(args.mlp_res_layers_global),
        mlp_norm=args.mlp_norm, merge_layer=args.merge_layer,
        use_depth=use_d, use_front_normal=use_f, use_back_normal=use_b,
        load_size=args.loadSize, z_size=args.z_size,
        compute_dtype=args.compute_dtype, remat=args.remat,
    )
    netMR = PIFuLevelConfig(
        num_stack=args.num_stack_local, hg_depth=args.hg_depth_local,
        hg_dim=args.hg_dim_local, norm=args.norm, hg_down="no_down",
        mlp_dim=tuple(args.mlp_dim_local),
        mlp_res_layers=tuple(args.mlp_res_layers_local),
        mlp_norm=args.mlp_norm, merge_layer=-1,
        use_depth=use_d, use_front_normal=use_f, use_back_normal=use_b,
        load_size=args.loadSize, z_size=args.z_size,
        compute_dtype=args.compute_dtype, remat=args.remat,
    )
    opt = Options(
        dataset=args.dataset, dataroot=args.dataroot, load_size=args.loadSize,
        load_size_big=args.loadSizeBig, load_size_local=args.loadSizeLocal,
        name=args.name, debug=args.debug, mode=args.mode,
        batch_size=args.batch_size, num_threads=args.num_threads,
        serial_batches=args.serial_batches, learning_rate=args.learning_rate,
        num_iter=args.num_iter, num_epoch=args.num_epoch,
        freq_save=args.freq_save,
        resume_epoch=args.resume_epoch, continue_train=args.continue_train,
        train_full_pifu=args.train_full_pifu, schedule=tuple(args.schedule),
        gamma=args.gamma, occ_loss_type=args.occ_loss_type,
        optimizer=args.optimizer, seed=args.seed,
        resolution=args.resolution, start_id=args.start_id,
        end_id=args.end_id, use_color=args.use_color,
        use_octree=not args.no_octree,
        num_refine_cells=args.num_refine_cells,
        octree_levels=args.octree_levels,
        num_refine_subcells=args.num_refine_subcells,
        auto_escalate_budget=not args.no_auto_escalate_budget,
        normal_mode=args.normal_mode,
        marching_algo=args.marching_algo,
        streamed_recon=not args.no_streamed_recon,
        mesh_format=args.mesh_format,
        num_sample_inout=args.num_sample_inout,
        sigma=args.sigma_max if args.sigma_max > 0 else args.sigma,
        sigma_max=args.sigma_max, sigma_min=args.sigma_min,
        z_size=args.z_size, netG=netG, netMR=netMR, num_local=args.num_local,
        checkpoints_path=args.checkpoints_path, results_path=args.results_path,
        load_netG_checkpoint_path=args.load_netG_checkpoint_path,
        load_netMR_checkpoint_path=args.load_netMR_checkpoint_path,
        mesh_shape=tuple(args.mesh_shape), dtype=args.dtype,
        use_aug=args.use_aug,
        aug_bri=args.aug_bri, aug_con=args.aug_con, aug_sat=args.aug_sat,
        aug_hue=args.aug_hue, aug_blur=args.aug_blur,
    )
    return (opt, args.device) if with_device else opt


def print_options(opt: Options) -> str:
    """Every field, with its default beside the ones that differ."""
    default = Options()
    lines = ["----------------- Options ---------------"]
    for f in dataclasses.fields(Options):
        v = getattr(opt, f.name)
        dv = getattr(default, f.name)
        comment = "" if v == dv else f"\t[default: {dv}]"
        lines.append(f"{f.name:>25}: {v!s:<30}{comment}")
    lines.append("----------------- End -------------------")
    msg = "\n".join(lines)
    print(msg, flush=True)
    return msg
