"""What each rank of the port's scale-out tests runs (tests/helpers/
torch_world.py starts the processes): fn(mesh, out, *args) fills `out`
with numpy arrays.  Port only (no JAX); inputs are made with numpy from
fixed seeds, so every rank and the tests' one-process references see the
same global arrays."""
import os

import numpy as np
import torch

from helpers.port_tiny import narrow, narrow_d, tiny, train_models

# ------------------------------------------------------------- collectives
STD_B, STD_SHAPE = 8, (3, 3, 4)


def stddev_inputs():
    """The global x, w, v and scale a of the minibatch-stddev checks."""
    rng = np.random.RandomState(0)
    x = rng.randn(STD_B, *STD_SHAPE).astype(np.float32)
    w = rng.randn(STD_B, *STD_SHAPE[:2], STD_SHAPE[2] + 1).astype(np.float32)
    v = rng.randn(STD_B, *STD_SHAPE).astype(np.float32)
    return x, w, v, np.float32(1.3)


def collectives(mesh, out):
    """minibatch_stddev across the ranks with its first and second
    derivatives (R1's pattern: grad with create_graph, then a backward),
    and the collectives' values."""
    from spgan_tpu_torch.models.discriminator import minibatch_stddev
    from spgan_tpu_torch.parallel import mesh as pm

    x, w, v, a0 = stddev_inputs()
    for group in (STD_B, 4):
        xl = pm.shard_batch(torch.tensor(x), mesh).requires_grad_(True)
        a = torch.tensor(a0, requires_grad=True)
        y = minibatch_stddev(a * xl, group, mesh)
        f = (y * pm.shard_batch(torch.tensor(w), mesh)).sum()
        (gx,) = torch.autograd.grad(f, xl, create_graph=True)
        (gx * pm.shard_batch(torch.tensor(v), mesh)).sum().backward()
        for k, t in (("y", y), ("gx", gx), ("hx", xl.grad), ("ha", a.grad)):
            out[f"g{group}/{k}"] = t.detach().numpy()

    r = mesh.rank
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r
    out["sum"] = pm.all_reduce_sum(t, mesh).numpy()
    out["mean"] = pm.all_reduce_mean(t, mesh).numpy()
    out["gathered"] = pm.all_gather_rows(t, mesh).numpy()
    got = pm.gather_rows(t, mesh)
    out["gather_to_0"] = np.zeros(0) if got is None else got.numpy()
    flat = [t.clone(), None, torch.full((3,), float(r), dtype=torch.float64)]
    pm.all_reduce_mean_(flat, mesh)
    out["flat_mean0"], out["flat_mean2"] = flat[0].numpy(), flat[2].numpy()
    tree = {"a": [t.clone()], "b": torch.tensor([r], dtype=torch.int32)}
    pm.replicate(tree, mesh)
    out["replicated_a"] = tree["a"][0].numpy()
    out["replicated_b"] = tree["b"].numpy()
    out["bcast_int"] = np.array(pm.broadcast_int(100 + r, mesh))
    out["shard"] = pm.shard_batch(
        torch.arange(4 * mesh.world_size).reshape(-1, 2), mesh, dim=0).numpy()


def ring(mesh, out, width=2, wrap_off=3):
    """ring_from_right on a rank-tagged tensor, and the halo path's
    exchange with device 0 sending from the wrap offset."""
    from spgan_tpu_torch.infer.halo import halo_from_right
    from spgan_tpu_torch.parallel.mesh import ring_from_right

    r = mesh.rank
    out["ring"] = ring_from_right(torch.full((2, 3), float(r)), mesh).numpy()
    cols = 6  # this rank's columns: global 6r .. 6r+5
    local = (torch.arange(cols, dtype=torch.float32) + cols * r).reshape(
        1, 1, cols, 1).repeat(2, 3, 1, 1)
    out["halo"] = halo_from_right(local, int(width), 2, int(wrap_off),
                                  mesh).numpy()


def abandon(mesh, out, coordinator, n, rank, port, group_timeout):
    """Rank 0 enters an all-reduce that rank 1 never joins (it sleeps past
    the group's timeout, then leaves).  The ranks first meet in a world
    with a long timeout (two children of a loaded machine can start
    seconds apart), then join a second world, on `port`, whose timeout
    is `group_timeout` seconds: a timeout that short would also bound the
    first rendezvous."""
    import time

    from spgan_tpu_torch.parallel.mesh import (all_reduce_sum, barrier,
                                               close, init_distributed)

    n, rank = int(n), int(rank)
    first = init_distributed(coordinator, n, rank, device="cpu",
                             timeout_s=60)
    barrier(first)
    close(first)
    mesh = init_distributed(f"127.0.0.1:{port}", n, rank, device="cpu",
                            timeout_s=float(group_timeout))
    if rank == 0:
        all_reduce_sum(torch.ones(2), mesh)
    else:
        time.sleep(10)
    close(mesh)


# ---------------------------------------------------------------- training
TRAIN_B = 8


def train_setup():
    """(cfg, G, D, state, patch, ac): the tiny training models, their state
    from seed 0 and a global batch of TRAIN_B made with numpy."""
    from spgan_tpu_torch.config import Config
    from spgan_tpu_torch.models.discriminator import Discriminator
    from spgan_tpu_torch.models.generator import Generator
    from spgan_tpu_torch.train.state import create_train_state

    cfg, g, d = train_models(Config, Generator, Discriminator, TRAIN_B)
    state = create_train_state(cfg, g, d, torch.Generator().manual_seed(0),
                               device="cpu")
    rng = np.random.RandomState(3)
    patch = rng.randn(TRAIN_B, 101, 101, 3).astype(np.float32)
    ac = rng.uniform(-1, 1, (TRAIN_B, 3)).astype(np.float32)
    return cfg, g, d, state, patch, ac


def flat_params(tree):
    from spgan_tpu_torch.tree import tree_leaves

    return np.concatenate([t.detach().reshape(-1).numpy()
                           for t in tree_leaves(tree)])


def train_steps(mesh, out):
    """A plain step and an R1+PPL step from the same state, on this rank's
    rows of the global batch and of the global draws of one generator."""
    from spgan_tpu_torch.parallel.mesh import shard_batch
    from spgan_tpu_torch.train.step import make_train_step

    cfg, g, d, state0, patch, ac = train_setup()
    step = make_train_step(cfg, g, d, mesh=mesh)
    patch = shard_batch(torch.tensor(patch), mesh)
    ac = shard_batch(torch.tensor(ac), mesh)
    for name, reg in (("plain", False), ("reg", True)):
        s1, m = step(state0, patch, ac, torch.Generator().manual_seed(1),
                     do_r1=reg, do_ppl=reg)
        for k, val in m.items():
            out[f"{name}/metric/{k}"] = np.float64(val)
        for tree in ("params_g", "params_d", "params_g_ema"):
            out[f"{name}/{tree}"] = flat_params(getattr(s1, tree))
        out[f"{name}/mean_path_length"] = s1.mean_path_length.numpy()


# --------------------------------------------------------------- train CLI
CLI_YAML = """\
train_params:
  global_latent_dim: 32
  local_latent_dim: 16
  channel_multiplier: 1
  n_mlp: 1
  ss_n_layers: 1
  batch_size: 8
log_params:
  n_save_sample: 4
  log_tick: 1
  img_tick: 100
  save_tick: 2
"""


def train_cli(_mesh, out, coordinator, n, rank, yaml_path, iters):
    """python -m spgan_tpu_torch.train with the multi-process flags, the
    networks narrowed as tests/test_torch_train_cli.py narrows them."""
    import spgan_tpu_torch.models.discriminator as pd
    import spgan_tpu_torch.models.generator as pg
    from spgan_tpu_torch.train.__main__ import main

    g_from, d_from = pg.Generator.from_config, pd.Discriminator.from_config

    def g_narrow(cfg):
        g = g_from(cfg)
        object.__setattr__(g.ts, "channel_base", 16)
        return g

    pg.Generator.from_config = staticmethod(g_narrow)
    pd.Discriminator.from_config = staticmethod(
        lambda cfg: narrow_d(d_from(cfg)))
    state = main([yaml_path, "--max-iters", iters, "--device", "cpu",
                  "--coordinator", coordinator, "--num-processes", n,
                  "--process-id", rank])
    out["step"] = np.array(state.step)
    out["params_g"] = flat_params(state.params_g)
    out["listing"] = np.array(sorted(
        os.path.relpath(os.path.join(d, f))
        for d, _, fs in os.walk(".") for f in fs) or [""])


# --------------------------------------------------------------- inference
def infer_generator(ss_n_layers=2, ss_disable_noise=True):
    """The port's tiny generator of tests/helpers/port_tiny.py with
    `ss_n_layers` SS layers (2: window 23; 1: window 17, halo 11)."""
    from spgan_tpu_torch.config import Config
    from spgan_tpu_torch.models.generator import Generator

    cfg = tiny(Config())
    cfg.train_params.ss_n_layers = int(ss_n_layers)
    cfg.train_params.ss_disable_noise = ss_disable_noise
    return cfg, narrow(Generator.from_config(cfg))


def ss_noise_params(g, weight):
    """The port's parameters of `g` (ss_disable_noise false) from seed 0,
    every SS noise weight set to `weight`."""
    params = g.init(torch.Generator().manual_seed(0), device="cpu")
    for b in params["ss"]["blocks"]:
        b["planar"]["noise"]["weight"].fill_(weight)
    return params


def plan_fields(plan, g, batch, seed):
    """Numpy fields (gl, z_field, noises) of a close-loop plan."""
    rng = np.random.RandomState(seed)
    gl = rng.randn(batch, 2, g.ts.global_dim).astype(np.float32)
    gl[:, 1] = gl[:, 0]
    z = rng.randn(batch, plan.z_field_h, plan.z_field_w,
                  g.ts.local_dim).astype(np.float32)
    noises = [rng.randn(batch, h, w, 1).astype(np.float32)
              for h, w in plan.noise_sizes]
    return gl, z, noises


def _torch_fields(gl, z, noises):
    return (torch.tensor(gl), torch.tensor(z),
            [torch.tensor(n) for n in noises])


def sharded(mesh, out, npz, height, width, batch=2, chunk=4, seed=11):
    """The lattice-sharded engine on numpy fields, and the folded engine
    on the same fields (every rank)."""
    from spgan_tpu_torch.compat.load import load_generator_params
    from spgan_tpu_torch.infer.engine import PanoramaEngine
    from spgan_tpu_torch.infer.stitcher import build_close_loop_plan

    cfg, g = infer_generator(2)
    params = load_generator_params(npz, g, device="cpu")
    eng = PanoramaEngine(g=g, plan=build_close_loop_plan(g, int(height),
                                                         int(width)),
                         batch=int(batch), patch_chunk=int(chunk),
                         grid_partial=cfg.train_params.partial, device="cpu")
    fields = _torch_fields(*plan_fields(eng.plan, g, int(batch), int(seed)))
    fn = eng.make_sharded_generate(mesh)
    out["meta"] = fn(params, *fields).numpy()
    out["chunks"] = np.array(fn.chunks)
    out["folded"] = eng.generate_from_fields(params, *fields).numpy()


def halo(mesh, out, npz, height, width, fields_npz, batch=1, seed=5):
    """The width-sharded halo path at one width: on the global fields of
    fields_npz (from_fields), and from a seed (every rank draws only its
    columns) beside the seed's global fields (assembled on every rank)."""
    from spgan_tpu_torch.compat.load import load_generator_params
    from spgan_tpu_torch.infer.halo import make_width_sharded_generate
    from spgan_tpu_torch.infer.stitcher import build_close_loop_plan

    cfg, g = infer_generator(1)
    params = load_generator_params(npz, g, device="cpu")
    plan = build_close_loop_plan(g, int(height), int(width))
    fn = make_width_sharded_generate(g, plan, mesh, int(batch),
                                     cfg.train_params.partial, device="cpu")
    f = np.load(fields_npz)
    fields = (f["gl"], f["z"], [f[f"noise{i}"]
                                for i in range(len(plan.noise_sizes))])
    for name, meta in (("fields", fn.from_fields(params, *fields)),
                       ("seed", fn(params, int(seed)))):
        if meta is not None:
            out[name] = meta.numpy()
    gl, z, noises = fn.global_fields(int(seed))
    out["seed_gl"], out["seed_z"] = gl.numpy(), z.numpy()
    for i, n in enumerate(noises):
        out[f"seed_noise{i}"] = n.numpy()
    out["cols_per_dev"], out["pad"] = (np.array(fn.cols_per_dev),
                                       np.array(fn.pad))


def halo_ss_noise(mesh, out, height, width, weight=0.5, seed=5):
    """The halo path with ss_disable_noise false, from a seed (every rank
    draws the SS noise maps), on ss_noise_params(weight); rank 0 keeps
    the meta image."""
    from spgan_tpu_torch.infer.halo import make_width_sharded_generate
    from spgan_tpu_torch.infer.stitcher import build_close_loop_plan

    cfg, g = infer_generator(1, ss_disable_noise=False)
    fn = make_width_sharded_generate(
        g, build_close_loop_plan(g, int(height), int(width)), mesh, 1,
        cfg.train_params.partial, device="cpu")
    meta = fn(ss_noise_params(g, float(weight)), int(seed))
    if meta is not None:
        out["seed"] = meta.numpy()


def infer_paths(mesh, out, tmp):
    """sharded at 128x672, halo at the widths of the fields files that
    tests/test_torch_scale_infer.py wrote under tmp and the halo with SS
    noise at 128x480; keys prefixed "sharded/", "halo<width>/" and
    "halo_ss_noise/"."""
    for name, fn, args in (
            [("sharded", sharded, (f"{tmp}/params2.npz", 128, 672))]
            + [(f"halo{w}", halo, (f"{tmp}/params1.npz", 128, w,
                                   f"{tmp}/fields{w}.npz"))
               for w in (384, 480)]
            + [("halo_ss_noise", halo_ss_noise, (128, 480))]):
        res = {}
        fn(mesh, res, *args)
        out.update({f"{name}/{k}": v for k, v in res.items()})


def infer_cli(_mesh, out, coordinator, n, rank, *argv):
    """python -m spgan_tpu_torch.infer in a world that torchrun's
    environment describes, the generator narrowed as port_tiny narrows
    it; `out` lists the PNGs this rank wrote under its working
    directory."""
    import spgan_tpu_torch.models.generator as pg
    from spgan_tpu_torch.infer.__main__ import main

    host, port = coordinator.split(":")
    os.environ.update(RANK=rank, LOCAL_RANK=rank, WORLD_SIZE=n,
                      MASTER_ADDR=host, MASTER_PORT=port)
    g_from = pg.Generator.from_config
    pg.Generator.from_config = staticmethod(lambda cfg: narrow(g_from(cfg)))
    main(list(argv) + ["--device", "cpu"])
    pngs = sorted(os.path.join(d, f) for d, _, fs in os.walk(".")
                  for f in fs if f.endswith(".png"))
    out["pngs"] = np.array(pngs or [""])
