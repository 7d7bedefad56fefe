"""Configuration dataclasses (a copy of ``rgbd_pifuhd_tpu.utils.options``).

Checkpoints embed ``Options.to_dict()``; ``from_dict`` restores them.  The
argparse bridge of the JAX package is not part of this port slice.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


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
