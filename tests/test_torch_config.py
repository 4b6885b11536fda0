"""The port's yaml reader, load_config and import_func (spgan_tpu_torch/
utils/yaml.py, config.py, utils/misc.py) against PyYAML and the JAX
package's load_config on the shipped configs."""
import dataclasses
import glob
import os
import warnings

import pytest
import yaml as pyyaml

from spgan_tpu.config import load_config as jax_load_config
from spgan_tpu_torch.config import UNPORTED_TRAIN_DEFAULTS, load_config
from spgan_tpu_torch.utils import yaml as yaml_subset
from spgan_tpu_torch.utils.misc import import_func, manually_seed
from test_cli_surface import MODEL_YAML, TEST_YAML


ROOT = os.path.join(os.path.dirname(__file__), "..")
MODEL_YAMLS = sorted(glob.glob(os.path.join(ROOT, "configs", "model", "*.yaml")))
TEST_YAMLS = sorted(glob.glob(os.path.join(ROOT, "configs", "test", "*.yaml")))


def _same(a, b):
    """Equal values of equal types, recursively (1 != 1.0 != True here)."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, list):
        return (isinstance(b, list) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("path", MODEL_YAMLS + TEST_YAMLS,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_yaml_reader_equals_safe_load_on_configs(path):
    with open(path) as f:
        want = pyyaml.safe_load(f)
    assert _same(yaml_subset.load(path), want)


@pytest.mark.parametrize("text", [
    MODEL_YAML, TEST_YAML, "",
    "# only a comment\n",
    "a: 1\nb:\n  c: 'it''s'  # trailing\n  d: \"q#r\"\ne: [1, -2.5, true, ~, 'z']\nf:\n",
    "x: a#b\nk: -3\nm: +4.\nn: .5\nq: 1.5e-3\nr: 256x512\ns: []\nt: Null\n",
    "top:\n    deep:\n        deeper: False\n    back: x y z\n",
])
def test_yaml_reader_equals_safe_load_inline(text):
    assert _same(yaml_subset.loads(text), pyyaml.safe_load(text))


@pytest.mark.parametrize("text, lineno", [
    ("a: 1\n- b\n", 2),                 # block sequence
    ("a: yes\n", 1),                    # YAML 1.1 boolean
    ("a: 1\nb: 1e-3\n", 2),             # YAML 1.1 reads this as a string
    ("a: 010\n", 1),                    # octal
    ("a: 0x1f\n", 1),
    ("a: 2001-12-14\n", 1),             # a date
    ("a: &x 1\n", 1),                   # anchor
    ("a: *x\n", 1),                     # alias
    ("a: !!str 1\n", 1),                # tag
    ("a: |\n  text\n", 1),              # block scalar
    ("a: [1, [2]]\n", 1),               # nested flow
    ("a: {b: 1}\n", 1),                 # flow mapping
    ("a: [1, 2\n", 1),                  # multi-line flow
    ("a: 'x\n", 1),
    ("a:\n  b: 1\n c: 2\n", 3),         # dedent to no enclosing level
    ("a: 1\n  b: 2\n", 2),
    ("a: 1\na: 2\n", 2),                # duplicate key
    ("a: 1\n\tb: 2\n", 2),              # tab
    ("1: a\n", 1),                      # non-string key
    ("a: b: c\n", 1),
])
def test_yaml_reader_raises_outside_subset(text, lineno):
    with pytest.raises(yaml_subset.YamlSubsetError) as e:
        yaml_subset.loads(text)
    assert e.value.lineno == lineno
    assert str(e.value).startswith(f"line {lineno}:")


@pytest.mark.parametrize("model", MODEL_YAMLS, ids=os.path.basename)
@pytest.mark.parametrize("test", TEST_YAMLS, ids=os.path.basename)
def test_load_config_matches_jax(model, test):
    """Every field the port has holds the JAX package's value, and a
    shipped yaml loads without a warning."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_load_config(model, test)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = load_config(model, test)
    assert (got.exp_name, got.log_dir) == (want.exp_name, want.log_dir)
    for sec in ("train_params", "data_params", "log_params", "test_params",
                "task"):
        for f in dataclasses.fields(getattr(got, sec)):
            a = getattr(getattr(got, sec), f.name)
            b = getattr(getattr(want, sec), f.name)
            assert _same(a, b), (sec, f.name, a, b)


def test_load_config_inline_yamls_and_overrides(tmp_path):
    m, t = tmp_path / "tiny_model.yaml", tmp_path / "tiny_test.yaml"
    m.write_text(MODEL_YAML)
    t.write_text(TEST_YAML)
    over = {"task.seed": 5, "train_params.compute_dtype": "bfloat16"}
    got = load_config(str(m), str(t), over)
    want = jax_load_config(str(m), str(t), over)
    for sec in ("train_params", "task"):
        for f in dataclasses.fields(getattr(got, sec)):
            assert getattr(getattr(got, sec), f.name) == \
                getattr(getattr(want, sec), f.name), f.name
    assert got.exp_name == "tiny_model"
    with pytest.raises(AttributeError):
        load_config(str(m), str(t), {"task.no_such_field": 1})


@pytest.mark.parametrize("key, value", [
    ("optimizer", "sgd"), ("lr_sch", [1000, 2000]), ("freeze", True),
    ("coord_use_pd", True), ("no_ext", False), ("steps_per_call", 4)])
def test_unported_train_key_raises_unless_default(tmp_path, key, value):
    """These keys were default-only until the port took their options:
    each now loads into its field as the JAX package loads it, with no
    warning; the one key still default-only (pallas_train_sampler, a TPU
    code path) raises unless it holds the JAX default."""
    p = tmp_path / "m.yaml"
    p.write_text(f"train_params:\n  {key}: {value}\n")
    assert key not in UNPORTED_TRAIN_DEFAULTS
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = getattr(load_config(str(p)).train_params, key)
    assert got == getattr(jax_load_config(str(p)).train_params, key) == value
    p.write_text("train_params:\n  pallas_train_sampler: 'off'\n")
    with pytest.raises(NotImplementedError, match="TPU"):
        load_config(str(p))
    p.write_text("train_params:\n  pallas_train_sampler: auto\n")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        load_config(str(p))


def test_unknown_keys_warn_once(tmp_path):
    p = tmp_path / "m.yaml"
    p.write_text("train_params:\n  mystery: 1\ntest_params:\n  calc_fid: "
                 "false\n  riddle: 2\n")
    with pytest.warns(UserWarning) as rec:
        cfg = load_config(str(p))
    assert len(rec) == 1
    assert "mystery" in str(rec[0].message)
    assert "test_params" in str(rec[0].message)
    assert "riddle" in str(rec[0].message)
    assert cfg.test_params.calc_fid is False


@pytest.mark.parametrize("path", [
    "models.spgan.spgan.InfinityGanGenerator",
    "models.stylegan2discriminator.StyleGan2Discriminator",
    "test_managers.close_loop_infinite_generation."
    "InfiniteGenerationManagerPatchCoordsCloseLoop",
    "test_managers.infinite_generation.InfiniteGenerationManager",
    "spgan_tpu.models.generator.Generator",
    "spgan_tpu.models.discriminator.Discriminator",
    "spgan_tpu.infer.close_loop.CloseLoopPanoramaManager",
    "spgan_tpu.infer.infinite.InfiniteGenerationManager",
    "spgan_tpu_torch.infer.managers.CloseLoopPanoramaManager",
])
def test_import_func_resolves_inside_the_port(path):
    assert import_func(path).__module__.startswith("spgan_tpu_torch.")


@pytest.mark.parametrize("path", [
    "os.path.join", "spgan_tpu.ops.pallas.sphere_kernel.fused_sphere_conv",
    "spgan_tpu_torch.models.generator.NoSuchClass", "Generator"])
def test_import_func_raises_outside_the_port(path):
    with pytest.raises(ValueError):
        import_func(path)


def test_manually_seed_seeds_every_global_generator():
    import random

    import numpy as np
    import torch

    draws = []
    for _ in range(2):
        manually_seed(11)
        draws.append((random.random(), np.random.rand(), float(torch.rand(1))))
    assert draws[0] == draws[1]
