"""The port's geometry and samplers (spgan_tpu_torch/geometry,
ops/grid_sample.py) against the JAX package and against the reference's
own grids (tests/golden/reference_grids.npz).

Both sides compute grids and tables in float32, with transcendental
functions of different libraries: positions agree to ~1e-6 of the patch,
tolerance 1e-5.  Integer floors can flip where a position sits on an
integer, so tables are compared as the positions they encode."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from spgan_tpu.geometry import coords as jc
from spgan_tpu.geometry import sphere_grid as jg
from spgan_tpu.ops import grid_sample as js
from spgan_tpu_torch.geometry import coords as tc
from spgan_tpu_torch.geometry import sphere_grid as tg
from spgan_tpu_torch.ops import grid_sample as ts

# (p_x_st, p_x_ed, p_y_st, p_y_ed, circular, grid_partial), x_total, y_total
CASES = [
    ((0.1, 0.65, 0.3, 0.85, 0.0, 0.6667), 65, 48),
    ((0.0, 0.5538, 0.875, 1.625, 1.0, 0.6667), 65, 48),   # wrapping crop
    ((0.05, 0.6, 0.2, 0.95, 0.0, 0.8), 45, 140),
    ((0.4615, 1.0154, 0.0, 0.75, 0.0, 0.6667), 65, 48),   # bottom rows
]


def _t(args):
    return [torch.tensor([a], dtype=torch.float32) for a in args[:5]]


@pytest.mark.parametrize("hw", [35, 17, 53])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_offset_tables_match_jax(case, hw):
    args, xt, yt = CASES[case]
    kw = dict(h=hw, w=hw, k=3, x_total=xt, y_total=yt)
    want = {k: np.asarray(v) for k, v in
            jg.sphere_offset_tables(*args, **kw).items()}
    got = {k: v[0].numpy() for k, v in
           tg.sphere_offset_tables(*_t(args), args[5], **kw).items()}
    assert got["y0"].dtype == got["sx"].dtype == np.int32

    def row_pos(t):  # continuous across a floor flip (and the clamp)
        return t["y0"] + t["wy"] * (t["y1"] - t["y0"])

    np.testing.assert_allclose(row_pos(got), row_pos(want), atol=1e-5)
    np.testing.assert_allclose(got["sx"] + got["fx"], want["sx"] + want["fx"],
                               atol=1e-5)


@pytest.mark.parametrize("hw", [35, 23])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_patch_grid_matches_jax(case, hw):
    args, xt, yt = CASES[case]
    kw = dict(h=hw, w=hw, k=3, x_total=xt, y_total=yt)
    want = np.asarray(jg.sphere_patch_grid(*args, **kw))
    got = tg.sphere_patch_grid(*_t(args), args[5], **kw)[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_patch_grid_matches_reference_golden(golden):
    n = 0
    for key in golden.files:
        if not key.startswith("patch_") or key.endswith("_meta"):
            continue
        (p_x_st, p_x_ed, p_y_st, p_y_ed, circ, x_total, y_total,
         test_flag, partial, h, w, k) = golden[key + "_meta"]
        grid_partial = float(partial) if test_flag else 0.8
        got = tg.sphere_patch_grid(
            *_t((p_x_st, p_x_ed, p_y_st, p_y_ed, circ)), grid_partial,
            h=int(h), w=int(w), k=int(k), x_total=int(x_total),
            y_total=int(y_total))[0].numpy()
        pat = golden[key]  # pixel-unit (lat, lon)
        want = np.stack([pat[0, :, :, 1] / y_total * 2 - 1,
                         pat[0, :, :, 0] / x_total * 2 - 1], axis=-1)
        np.testing.assert_allclose(got, want, atol=2e-5, err_msg=key)
        n += 1
    assert n >= 30


def test_coord_fields_and_encoding(golden):
    got = tc.CoordGrid().test_field(59, 48)
    np.testing.assert_array_equal(got, jc.CoordGrid().test_field(59, 48))
    np.testing.assert_allclose(got.transpose(2, 0, 1),
                               golden["test_grid_59x48"], atol=1e-6)
    np.testing.assert_allclose(tc.CoordGrid().base_grid().transpose(2, 0, 1),
                               golden["const_grid"], atol=1e-6)
    raw = np.random.RandomState(0).randn(2, 5, 5, 3).astype(np.float32)
    np.testing.assert_allclose(
        tc.encode_coords(torch.as_tensor(raw)).numpy(),
        np.asarray(jc.encode_coords(jnp.asarray(raw))), atol=1e-6)


@pytest.mark.parametrize("groups", [0, 2])
@pytest.mark.parametrize("hw", [17, 29])
def test_tap_conv_tables_matches_jax(hw, groups):
    """The TS skip convs' row-offset tap conv (C=3), with the exact
    margin of its tables."""
    rng = np.random.RandomState(hw)
    B = 4
    n_tab = groups or B
    cps = np.array([CASES[i % len(CASES)][0] for i in range(n_tab)],
                   np.float32)
    tabs_j = jax.vmap(lambda a, b, c, d, e: jg.sphere_offset_tables(
        a, b, c, d, e, 0.6667, h=hw, w=hw, k=3, x_total=65, y_total=48))(
        *[jnp.asarray(cps[:, i]) for i in range(5)])
    tabs = {k: np.asarray(v) for k, v in tabs_j.items()}
    margin = max(6, int(np.abs(tabs["sx"]).max()) + 1)
    z = rng.randn(B, hw, hw, 3).astype(np.float32)
    w9 = (rng.randn(9, 3, 3) / 3).astype(np.float32)
    want = js.tap_conv_tables(jnp.asarray(z), tabs_j, jnp.asarray(w9),
                              margin=margin, groups=groups)
    got = ts.st_tap_conv(torch.as_tensor(z),
                         {k: torch.tensor(v) for k, v in tabs.items()},
                         torch.as_tensor(w9), margin=margin, groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("groups", [0, 2])
def test_st_grid_sample_3x3_forward_matches_jax(groups):
    rng = np.random.RandomState(11)
    B, hw = 4, 11
    n_grid = groups or B
    grids = np.stack([np.asarray(jg.sphere_patch_grid(
        *CASES[i % len(CASES)][0], h=hw, w=hw, k=3, x_total=65, y_total=48))
        for i in range(n_grid)])
    z = rng.randn(B, hw, hw, 3).astype(np.float32)
    want = js.st_grid_sample_3x3(jnp.asarray(z), jnp.asarray(grids), groups)
    got = ts.st_grid_sample_3x3(torch.as_tensor(z), torch.as_tensor(grids),
                                groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
