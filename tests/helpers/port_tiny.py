"""The tiny generator config the port's serving and editing tests share
with tests/test_serve.py and tests/test_interactive.py (channel_base 48,
2 SS layers, 128x672), for either package's Config, the tiny training
models of tests/test_torch_train.py, the port's parameter tree in the
JAX package's layout, and the CPU budget those tests keep.  Imports no
JAX at module level (the scale-out tests' child processes import it)."""
import contextlib

import torch

MODEL_YAML = """
train_params:
  global_latent_dim: 32
  local_latent_dim: 16
  channel_multiplier: 1
  n_mlp: 2
  ss_n_layers: 2
"""


def tiny(cfg, batch_size=1):
    tp = cfg.train_params
    tp.global_latent_dim = 32
    tp.local_latent_dim = 16
    tp.channel_multiplier = 1
    tp.n_mlp = 2
    tp.ss_n_layers = 2
    cfg.task.height, cfg.task.width = 128, 672
    cfg.task.batch_size = batch_size
    return cfg


def narrow(g):
    object.__setattr__(g.ts, "channel_base", 48)
    return g


def narrow_d(d):
    """A discriminator of 16 channels at every size."""
    object.__setattr__(d, "channels", lambda: dict.fromkeys(
        d.__class__.channels(d), 16))
    return d


def train_models(Config, Generator, Discriminator, batch_size=8):
    """(cfg, G, D) of either package at tests/test_torch_train.py's tiny
    training widths (channel_base 16, D channels 16, 1 SS layer), batch
    `batch_size`."""
    cfg = Config()
    tp = cfg.train_params
    tp.global_latent_dim = 32
    tp.local_latent_dim = 16
    tp.channel_multiplier = 1
    tp.batch_size = batch_size
    tp.n_mlp = 1
    tp.ss_n_layers = 1
    tp.path_batch_shrink = 2
    g = Generator.from_config(cfg)
    object.__setattr__(g.ts, "channel_base", 16)
    d = Discriminator(patch_size=101, channel_multiplier=1,
                      batch_size=batch_size, use_coord_ac=True,
                      coord_num_dir=3, linear_ch=16)
    return cfg, g, narrow_d(d)


def jax_layout(node, name=""):
    """The port's parameter tree in the JAX package's layout (numpy, conv
    weights HWIO, linear weights (in, out))."""
    if isinstance(node, dict):
        return {k: jax_layout(v, k) for k, v in node.items()}
    if isinstance(node, list):
        return [jax_layout(v, name) for v in node]
    a = node.numpy()
    if name == "weight" and a.ndim == 4:
        return a.transpose(2, 3, 1, 0)
    return a.T if name == "weight" and a.ndim == 2 else a


def write_yamls(root, **task_keys):
    """A tiny model yaml and a 128x672 close-loop test yaml under `root`;
    returns the CLI's config arguments."""
    model, test = root / "tiny_model.yaml", root / "tiny_test.yaml"
    model.write_text(MODEL_YAML)
    keys = {"seed": 17, "height": 128, "width": 672, "batch_size": 1,
            "num_gen": 1, **task_keys}
    test.write_text('task_manager: "spgan_tpu.infer.close_loop.'
                    'CloseLoopPanoramaManager"\n'
                    + "".join(f"{k}: {v}\n" for k, v in keys.items()))
    return ["--model-config", str(model), "--test-config", str(test)]


@contextlib.contextmanager
def cpu_budget():
    """Two torch intra-op threads (the suite runs several test processes
    side by side, and a process per core's worth of spinning threads
    slows them all several-fold), and XLA compiles with most
    optimisations off: each JAX reference compiles once and runs once, so
    its compile is the cost (the draws and the inversion step compile in
    about a third of the time; values move by float rounding only)."""
    import jax

    n = torch.get_num_threads()
    opt = jax.config.read("jax_disable_most_optimizations")
    torch.set_num_threads(2)
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        torch.set_num_threads(n)
        jax.config.update("jax_disable_most_optimizations", opt)
