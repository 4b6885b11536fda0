"""The port's torch.distributed collectives (spgan_tpu_torch/parallel/
mesh.py) and the cross-rank minibatch stddev, in worlds of CPU processes
over gloo (tests/helpers/torch_world.py; the module's worlds start once,
together; every child and every process group have a timeout).

A 2-rank world holds the collectives and minibatch_stddev: the
statistic, its gradient and its second derivative (R1's pattern:
grad with create_graph, then a backward) on each rank's rows equal
JAX's minibatch_stddev on the whole numpy batch, at atol 1e-5 (float32
sums in another order).  A 3-rank world shows the ring's direction and
the halo's wrap offset, which two ranks cannot tell apart."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from spgan_tpu.models.discriminator import minibatch_stddev as jmbstd
from spgan_tpu_torch.models.discriminator import minibatch_stddev
from spgan_tpu_torch.parallel import mesh as pm

from helpers.scale_scenarios import STD_B, stddev_inputs
from helpers.torch_world import free_port, start_world


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The module's three worlds, started together: the collectives on 2
    ranks, the ring on 3, and a collective that times out on 2 (its
    process group's timeout 4 s)."""
    tmp = tmp_path_factory.mktemp("worlds")
    started = [
        start_world("helpers.scale_scenarios:collectives", 2, tmp),
        start_world("helpers.scale_scenarios:ring", 3, tmp, args=(2, 3)),
        start_world("helpers.scale_scenarios:abandon", 2, tmp,
                    join=False, args=(free_port(), 4))]
    try:
        return [w.results(check=i < 2) for i, w in enumerate(started)]
    finally:
        for w in started:   # ended already, unless an earlier one failed
            w.close()


@pytest.fixture(scope="module")
def world2(worlds):
    return worlds[0]


@pytest.fixture(scope="module")
def world3(worlds):
    return worlds[1]


def _jax_stddev(group):
    """JAX's statistic, gradient and second derivatives on the batch."""
    x, w, v, a = stddev_inputs()

    def f(x, a):
        return jnp.sum(jmbstd(a * x, group) * w)

    def h(x, a):
        return jnp.sum(jax.grad(f)(x, a) * v)

    hx, ha = jax.grad(h, argnums=(0, 1))(x, a)
    return {"y": np.asarray(jmbstd(a * x, group)),
            "gx": np.asarray(jax.grad(f)(x, a)), "hx": np.asarray(hx),
            "ha": np.asarray(ha)}


@pytest.mark.parametrize("group", [STD_B, 4])
def test_minibatch_stddev_across_ranks_matches_jax(world2, group):
    want = _jax_stddev(group)
    n = STD_B // 2
    for r, res in enumerate(world2):
        rows = slice(r * n, (r + 1) * n)
        for k in ("y", "gx", "hx"):
            np.testing.assert_allclose(res[f"g{group}/{k}"], want[k][rows],
                                       atol=1e-5, err_msg=f"rank {r} {k}")
    # the scale's second derivative: the ranks' shares sum to JAX's
    np.testing.assert_allclose(sum(r[f"g{group}/ha"] for r in world2),
                               want["ha"], rtol=1e-5)


def test_minibatch_stddev_world_of_one_is_the_local_path():
    x = torch.tensor(stddev_inputs()[0])
    for group in (STD_B, 4):
        np.testing.assert_array_equal(
            minibatch_stddev(x, group, pm.Mesh()).numpy(),
            minibatch_stddev(x, group).numpy())
        np.testing.assert_allclose(minibatch_stddev(x, group).numpy(),
                                   np.asarray(jmbstd(x.numpy(), group)),
                                   atol=1e-6)


def test_collectives(world2):
    t = [np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r
         for r in range(2)]
    for r, res in enumerate(world2):
        np.testing.assert_array_equal(res["sum"], t[0] + t[1])
        np.testing.assert_array_equal(res["mean"], (t[0] + t[1]) / 2)
        np.testing.assert_array_equal(res["gathered"], np.concatenate(t))
        np.testing.assert_array_equal(
            res["gather_to_0"], np.concatenate(t) if r == 0 else np.zeros(0))
        np.testing.assert_array_equal(res["flat_mean0"], (t[0] + t[1]) / 2)
        np.testing.assert_array_equal(res["flat_mean2"], np.full(3, 0.5))
        np.testing.assert_array_equal(res["replicated_a"], t[0])
        np.testing.assert_array_equal(res["replicated_b"], [0])
        assert int(res["bcast_int"]) == 100
        np.testing.assert_array_equal(res["shard"],
                                      np.arange(8).reshape(4, 2)[2 * r:
                                                                 2 * r + 2])


def test_ring_from_right_moves_each_slice_left(world3):
    for r, res in enumerate(world3):
        np.testing.assert_array_equal(res["ring"],
                                      np.full((2, 3), (r + 1) % 3))


def test_halo_from_right_sends_from_the_wrap_offset(world3):
    """Rank r holds global columns 6r..6r+5; it receives the first 2 of
    its right neighbour's, and the last rank receives rank 0's columns
    from the wrap offset 3."""
    want = {0: [6, 7], 1: [12, 13], 2: [3, 4]}
    for r, res in enumerate(world3):
        assert res["halo"].shape == (2, 3, 2, 1)
        np.testing.assert_array_equal(res["halo"][0, 0, :, 0], want[r])


def test_world_of_one(monkeypatch):
    """No process group: init_distributed is a no-op, and every
    collective is the identity or a local copy."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    mesh = pm.init_distributed(device="cpu")
    assert mesh == pm.Mesh(device=torch.device("cpu"))
    assert pm.make_mesh() == pm.Mesh()
    t = torch.arange(4.0)
    for fn in (pm.all_reduce_sum, pm.all_reduce_mean, pm.all_gather_rows,
               pm.ring_from_right):
        np.testing.assert_array_equal(fn(t, mesh).numpy(), t.numpy())
    assert pm.broadcast_int(7, mesh) == 7


def test_more_local_ranks_than_cards_raise(monkeypatch):
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="local rank 1 needs cuda:1"):
        pm.init_distributed("127.0.0.1:1", 2, 1)


def test_a_collective_that_times_out_fails_the_run(worlds):
    """A collective whose peer does not join it within the process
    group's timeout (4 s here) raises; it does not wait."""
    rcs, logs = worlds[2]
    assert rcs[1] == 0 and rcs[0] != 0, logs
    assert "Timed out" in logs[0], logs[0][-2000:]
