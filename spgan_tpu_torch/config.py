"""Typed configuration: the port's own copy of the fields the panorama
engine and the training step read, with the shipped defaults of
``spgan_tpu/config.py`` (reference configs/model/spgan.yaml and
configs/test/spgan_384x768.yaml).  There is no yaml loader: ``Config()``
already holds spgan.yaml's values.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass
class TrainParams:
    # data geometry
    data_size: Tuple[int, int] = (768, 256)
    extra_pre_resize: Optional[int] = 256
    full_size: int = 197
    patch_size: int = 101
    training_modality: str = "patch"
    partial: float = 0.6667  # vertical fraction of the sphere kept by the pano

    # optimization
    batch_size: int = 16
    iter: int = 800000
    r1: float = 10.0
    path_regularize: float = 2.0
    path_batch_shrink: int = 2
    d_reg_every: int = 16
    g_reg_every: int = 4
    mixing: float = 0.9
    lr: float = 0.002
    g_path_start: int = 100000
    d_weight: float = 1.0           # D lr ratio

    # architecture
    styleGAN2_baseline: bool = False
    global_latent_dim: int = 512
    local_latent_dim: int = 256
    n_mlp: int = 8
    channel_multiplier: int = 2
    # uniform D width scale: channels AND the 512-wide head linears
    d_extra_multiplier: float = 1.0

    # structure synthesizer
    use_ss: bool = True
    ss_n_layers: int = 4
    ss_unfold_radius: int = 3
    ss_coord_all_layers: str = "each_layer"
    ss_disable_noise: bool = True
    ss_mapping: bool = False

    # texture synthesizer
    ts_input_size: int = 11
    ts_no_zero_pad: bool = True

    # diversity (mode-seeking) loss
    diversity_z_w: float = 1.0
    diversity_angular: bool = True
    diversity_dual: bool = True

    # coordinate system
    coord_continuous: bool = True
    coord_vert_sample_size: int = 10
    coord_hori_occupy_ratio: float = 0.25
    coord_vert_cut_pt: float = 3.0
    coord_num_dir: int = 3
    coord_use_ac: bool = True
    coord_ac_w: float = 1.0
    coord_ac_vert_only: bool = True
    coord_ac_hori_only: bool = False

    # numerics
    compute_dtype: str = "float32"  # "float32" | "bfloat16"

    @property
    def ss_unfold_size(self) -> int:
        return self.ss_n_layers * self.ss_unfold_radius


@dataclass
class TaskConfig:
    """Inference-task config (the reference's test yaml)."""

    height: int = 384
    width: int = 768
    batch_size: int = 16
    # how many lattice positions are folded into one generator batch
    patch_chunk: int = 4


@dataclass
class Config:
    train_params: TrainParams = field(default_factory=TrainParams)
    task: TaskConfig = field(default_factory=TaskConfig)
