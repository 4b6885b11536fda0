"""Typed configuration: the port's own copy of the fields the panorama
engine reads, with the shipped defaults of ``spgan_tpu/config.py``
(reference configs/model/spgan.yaml and configs/test/spgan_384x768.yaml).
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class TrainParams:
    # data geometry
    full_size: int = 197
    patch_size: int = 101
    training_modality: str = "patch"
    partial: float = 0.6667  # vertical fraction of the sphere kept by the pano

    # architecture
    styleGAN2_baseline: bool = False
    global_latent_dim: int = 512
    local_latent_dim: int = 256
    n_mlp: int = 8
    channel_multiplier: int = 2

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

    # coordinate system
    coord_continuous: bool = True
    coord_vert_sample_size: int = 10
    coord_hori_occupy_ratio: float = 0.25
    coord_vert_cut_pt: float = 3.0
    coord_num_dir: int = 3

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
