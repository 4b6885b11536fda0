"""Typed configuration: the port's own copy of the fields the panorama
engine, the managers, the training step and the training loop read (the
train, data, log and test sections of a model yaml, and the test yaml),
with the shipped defaults of ``spgan_tpu/config.py`` (reference
configs/model/spgan.yaml and configs/test/spgan_384x768.yaml), and
``load_config``, which reads the reference-compatible yaml files
(``utils/yaml.py``, no PyYAML needed).
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from spgan_tpu_torch.utils import yaml


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
    optimizer: str = "adam"          # "adam" | "sgd"
    d_weight: float = 1.0           # D lr ratio
    lr_sch: Optional[Tuple[int, ...]] = None  # MultiStepLR milestones, gamma 0.5
    freeze: bool = False            # freeze baseline-loaded G keys + all of D

    # architecture (the JAX package's class paths; utils.misc.import_func
    # maps them onto this package)
    styleGAN2_baseline: bool = False
    g_arch: str = "spgan_tpu.models.generator.Generator"
    d_arch: str = "spgan_tpu.models.discriminator.Discriminator"
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
    coord_use_pd: bool = False
    coord_pd_w: float = 0.0
    coord_ac_vert_only: bool = True
    coord_ac_hori_only: bool = False
    coord_ac_categorical: bool = False
    coord_pd_hori_only: bool = False
    no_ext: bool = True

    # numerics
    compute_dtype: str = "float32"  # "float32" | "bfloat16"
    # training steps per loop call (one batch each; 1 == one step a call)
    steps_per_call: int = 1

    @property
    def ss_unfold_size(self) -> int:
        return self.ss_n_layers * self.ss_unfold_radius


@dataclass
class DataParams:
    dataset: str = "Matterport3d"
    num_train: int = 10000
    lmdb_root: str = "infinityGAN-lmdb"
    raw_data_root: str = "data/matterport3d_panorama"
    source: str = "synthetic"  # "synthetic" | "folder" | "npy" | "lmdb" | "spr"
    folder: Optional[str] = None
    # source "lmdb" only: the key prefix before "-<index>" (e.g. "256");
    # required when the LMDB stores several resolutions
    lmdb_key_prefix: Optional[str] = None


@dataclass
class LogParams:
    n_save_sample: int = 64
    log_tick: int = 1000
    img_tick: int = 3000
    eval_tick: int = 15000
    save_tick: int = 3000
    fid_ext2_tick: int = 30000


@dataclass
class TestParams:
    # FID every eval_tick (and EXT2-FID every fid_ext2_tick) over
    # n_fid_sample generations, when $SPGAN_TPU_INCEPTION names the
    # inception weights (train/evals.py); without them the loop says so
    # and runs without FID, as the JAX package does
    calc_fid: bool = True
    calc_fid_ext2: bool = True
    n_fid_sample: int = 10000


@dataclass
class TaskConfig:
    """Inference-task config (the reference's test yaml)."""

    task_manager: str = "spgan_tpu.infer.close_loop.CloseLoopPanoramaManager"
    interactive: bool = False
    seed: int = 9000
    height: int = 384
    width: int = 768
    batch_size: int = 16
    num_gen: int = 10000
    # accepted for reference-yaml compatibility; read by no code
    lowres_height: int = 128
    # the reference's parallel batching; maps onto patch_chunk
    parallel_batch_size: Optional[int] = None
    init_index: Optional[int] = None
    # per-batch seeds: batch i draws from a generator seeded with i
    seeds: bool = False
    # how many lattice positions are folded into one generator batch
    patch_chunk: int = 4
    # "folded" (one device); "sharded" and "halo" are not ported (A12)
    engine: str = "folded"


@dataclass
class Config:
    train_params: TrainParams = field(default_factory=TrainParams)
    data_params: DataParams = field(default_factory=DataParams)
    log_params: LogParams = field(default_factory=LogParams)
    test_params: TestParams = field(default_factory=TestParams)
    task: TaskConfig = field(default_factory=TaskConfig)
    exp_name: str = "spgan"
    log_dir: str = "logs"


# train_params keys of the JAX package with no field here: the port runs
# only their JAX defaults (spgan_tpu/config.py), and a yaml that sets
# another value raises rather than train or render a different model.
# pallas_train_sampler chooses between a Pallas kernel and XLA's gathers
# on a TPU; the port always runs its tap-sampler kernel on the card.
UNPORTED_TRAIN_DEFAULTS: Dict[str, Any] = {
    "pallas_train_sampler": "auto",
}


def _apply_section(dc, data: Dict[str, Any]) -> Dict[str, Any]:
    """Overlay a dict onto a dataclass instance (list -> tuple where the
    field holds a tuple); returns the keys it has no field for."""
    valid = {f.name for f in dataclasses.fields(dc)}
    unknown = {}
    for k, v in data.items():
        if k in valid:
            if isinstance(getattr(dc, k), tuple) and isinstance(v, list):
                v = tuple(v)
            setattr(dc, k, v)
        else:
            unknown[k] = v
    return unknown


def load_config(model_yaml: Optional[str] = None,
                test_yaml: Optional[str] = None,
                overrides: Optional[Dict[str, Any]] = None) -> Config:
    """A Config from reference-compatible yaml files (counterpart of
    spgan_tpu.config.load_config): the model yaml's train_params, the test
    yaml under ``task``, then ``overrides`` ({"task.seed": 1, ...}).

    A train_params key of the JAX package that the port has no field for
    raises NotImplementedError unless it holds the JAX default.  Keys no
    section knows are named in one warning."""
    cfg = Config()
    ignored: Dict[str, Any] = {}
    if model_yaml is not None:
        raw = yaml.load(model_yaml) or {}
        for section in ("data_params", "log_params", "test_params"):
            unknown = _apply_section(getattr(cfg, section),
                                     raw.get(section) or {})
            if unknown:
                ignored[f"{section} (unrecognized)"] = unknown
        unknown = _apply_section(cfg.train_params,
                                 raw.get("train_params") or {})
        for k in list(unknown):
            if k not in UNPORTED_TRAIN_DEFAULTS:
                continue
            v = unknown.pop(k)
            if v != UNPORTED_TRAIN_DEFAULTS[k]:
                raise NotImplementedError(
                    f"train_params.{k} = {v!r} chooses a TPU code path; the "
                    f"port runs only the JAX default "
                    f"{UNPORTED_TRAIN_DEFAULTS[k]!r}")
        if unknown:
            ignored["train_params (unrecognized)"] = unknown
        cfg.exp_name = os.path.splitext(os.path.basename(model_yaml))[0]
    if test_yaml is not None:
        unknown = _apply_section(cfg.task, yaml.load(test_yaml) or {})
        if unknown:
            ignored["task (unrecognized)"] = unknown
    for dotted, v in (overrides or {}).items():
        obj = cfg
        *path, last = dotted.split(".")
        for p in path:
            obj = getattr(obj, p)
        if not hasattr(obj, last):
            raise AttributeError(f"no config field {dotted!r}")
        setattr(obj, last, v)
    if ignored:
        warnings.warn(f"Unrecognized config keys ignored: {ignored}")
    return cfg
