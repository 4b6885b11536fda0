"""StyleGAN3-T on the CPU (models/stylegan3.py, ops/filtered_lrelu.py): the
layer schedule at 1024x1024 against the published table, the filter
designer against scipy's firwin, the filtered LeakyReLU against the plain
reference's ``_filtered_lrelu_ref``, the whole generator against
portbench/reference/stylegan3.py on seeded random weights, and the
inference CLI writing PNGs through ImageGenerationManager.

Tiny widths and torch at 2 threads: the file runs in a few seconds."""
import dataclasses
import math

import numpy as np
import pytest
import scipy.signal
import torch

from portbench.reference import stylegan3 as ref
from spgan_tpu_torch.config import Config, StyleGAN3Params, load_config
from spgan_tpu_torch.models import stylegan3 as sg3
from spgan_tpu_torch.ops import filtered_lrelu as fl
from spgan_tpu_torch.utils import trace

torch.set_num_threads(2)

# NVlabs' layers of StyleGAN3-T at 1024x1024: (size, channels, sampling
# rate, up, down, up taps, down taps)
TABLE = [(36, 512, 16, 2, 2, 12, 12), (36, 512, 16, 2, 2, 12, 12),
         (52, 512, 32, 4, 2, 24, 12), (52, 512, 32, 2, 2, 12, 12),
         (84, 512, 64, 4, 2, 24, 12), (148, 512, 128, 4, 2, 24, 12),
         (148, 512, 128, 2, 2, 12, 12), (276, 323, 256, 4, 2, 24, 12),
         (276, 203, 256, 2, 2, 12, 12), (532, 128, 512, 4, 2, 24, 12),
         (1044, 81, 1024, 4, 2, 24, 12), (1044, 51, 1024, 2, 2, 12, 12),
         (1044, 32, 1024, 2, 2, 12, 12), (1024, 32, 1024, 2, 2, 12, 12),
         (1024, 3, 1024, 1, 1, 1, 1)]

# a tiny StyleGAN3-T: 64x64, 6 layers and the ToRGB; it keeps up-4
# layers (L2, L3) and both critically sampled layers (L4, L5)
TINY = dict(img_resolution=64, num_layers=6, channel_base=1024,
            channel_max=32, margin_size=4)


def _tiny_cfg():
    cfg = Config()
    cfg.stylegan3 = StyleGAN3Params(**TINY)
    return cfg


def test_schedule_is_the_published_table():
    inp, layers = sg3.schedule(StyleGAN3Params())
    assert (inp.channels, inp.size, inp.sampling_rate, inp.bandwidth) == (
        512, 36, 16.0, 2.0)
    got = [(L.out_size, L.out_channels, L.out_sampling_rate, L.up_factor,
            L.down_factor, L.up_taps, L.down_taps) for L in layers]
    assert got == TABLE
    names = [L.name for L in layers]
    assert names[0] == "L0_36_512" and names[-1] == "L14_1024_3"
    assert [L.use_fp16 for L in layers] == [False] * 5 + [True] * 10
    assert [L.is_critically_sampled for L in layers] == [False] * 12 + [
        True] * 3
    # NVlabs' pad_lo / pad_hi: positive on the up-2 layers, crops on the
    # up-4 layers and the last critically sampled one
    assert layers[0].padding == (9, 8, 9, 8)
    assert layers[2].padding == (-6, -9, -6, -9)
    assert layers[13].padding == (-11, -12, -11, -12)
    assert layers[14].padding == (0, 0, 0, 0)
    assert not layers[14].conv_kernel - 1


def test_schedule_is_the_reference_schedule():
    sg = StyleGAN3Params()
    _, layers = sg3.schedule(sg)
    want = ref.schedule(dataclasses.asdict(sg))["layers"]
    for L, R in zip(layers, want):
        assert L.name == R["name"]
        assert list(L.padding) == R["padding"]
        assert (L.up_factor, L.down_factor) == (R["up"], R["down"])


def test_filters_are_scipy_firwin():
    """Every filter of the 1024x1024 schedule, as scipy.signal.firwin
    designs it, to 1e-6 (float32 taps of float64 designs)."""
    g = sg3.Generator.from_config(Config())
    n = 0
    for layer in g.layers:
        sp = layer.spec
        fs = sp.up_factor * sp.in_sampling_rate
        for taps, filt, cut, hw in (
                (sp.up_taps, layer.up_filter, sp.in_cutoff,
                 sp.in_half_width),
                (sp.down_taps, layer.down_filter, sp.out_cutoff,
                 sp.out_half_width)):
            if taps == 1:
                assert filt is None
                continue
            want = scipy.signal.firwin(taps, cut, width=hw * 2, fs=fs)
            assert np.abs(np.asarray(filt) - want).max() < 1e-6
            assert np.abs(ref.firwin(taps, cut, hw * 2, fs) - want).max() \
                < 1e-12
            n += 1
    assert n == 28


@pytest.mark.parametrize("up, pad", [(2, (9, 8, 9, 8)), (4, (-6, -9, -6, -9)),
                                     (2, (-11, -12, -11, -12)),
                                     (4, (3, 1, 2, 5))])
def test_filtered_lrelu_is_the_reference(up, pad):
    """Bias, upsample by `up`, LeakyReLU * sqrt(2) with the clamp, down 2,
    at the layers' own paddings (and an uneven one), in float32; values
    up to ~8 and a clamp at 4 so that it bites.  The gain is folded into
    the down filter and the transposed conv sums in another order: 1e-5
    of values ~8 is float32 rounding."""
    gen = torch.Generator().manual_seed(up * 31 + pad[0])
    x = torch.randn((2, 24, 26, 5), generator=gen) * 4
    b = torch.randn((5,), generator=gen)
    scale = torch.rand((2, 5), generator=gen) + 0.5
    fu = fl.design_lowpass_filter(6 * up, 3.0, 4.0, 8.0 * up)
    fd = fl.design_lowpass_filter(12, 4.0, 3.0, 16.0)
    got = fl.filtered_lrelu(x, fu, fd, b, scale, up=up, down=2, padding=pad,
                            clamp=4.0)
    xs = (x * scale[:, None, None, :]).permute(0, 3, 1, 2)
    want = ref.filtered_lrelu(xs, torch.as_tensor(fu), torch.as_tensor(fd),
                              b, up=up, down=2, padding=pad,
                              clamp=4.0).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) < 1e-5


def _tiny_weights(seed):
    sg = dataclasses.asdict(StyleGAN3Params(**TINY))
    gen = torch.Generator().manual_seed(seed)
    params = ref.init(sg, gen, "cpu")
    z = torch.randn((3, 512), generator=gen)
    ref.calibrate_magnitudes(sg, params, z[:2])
    return sg, params, z


@pytest.mark.parametrize("seed", [3, 11])
def test_generator_is_the_reference(seed):
    """The program (a batch of 3, float32 on the CPU) against the plain
    reference (one image at a time) on the reference's init with
    calibrated magnitudes.  The program computes the demodulation apart
    from the weights and folds the filters' gains, so it sums in other
    orders: 2e-5 of images of RMS ~0.25 is float32 rounding through 7
    layers."""
    sg, params, z = _tiny_weights(seed)
    g = sg3.Generator.from_config(_tiny_cfg())
    p = g.params_from_state_dict(params, device="cpu")
    with torch.no_grad():
        got = g.apply(p, z)
        want = ref.generate(sg, params, z)
    assert got.shape == (3, 64, 64, 3) and got.dtype == torch.float32
    assert 0.05 < float(want.std()) < 1.0
    assert float((got - want).abs().max()) < 2e-5


def test_spans_and_counters_a_generate():
    """The filtered LeakyReLU span opens once a layer but the ToRGB's; the
    input span once; on the CPU every layer counts as float32."""
    g = sg3.Generator.from_config(_tiny_cfg())
    p = g.init(torch.Generator().manual_seed(0), device="cpu")
    trace.reset()
    trace.enable()
    try:
        with torch.no_grad():
            g.apply(p, torch.randn((1, 512)))
    finally:
        trace.disable()
    names = [r["name"] for r in trace.records()]
    assert names.count("spgan.sg3.filtered_lrelu") == 6
    assert names.count("spgan.sg3.input") == 1
    c = trace.counters()
    assert c.get("spgan.sg3.layers_fp32") == 7
    assert "spgan.sg3.layers_fp16" not in c
    trace.reset()


def test_layer_dtypes_follow_num_fp16_res():
    """num_fp16_res alone sets each layer's precision, as in NVlabs: float16
    above the float32 head on the card, float32 on the CPU; an SP-GAN
    compute_dtype other than float32 is refused, not followed."""
    g = sg3.Generator.from_config(Config())
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert [g.layer_dtype(L, cuda) for L in g.layers] == (
        [torch.float32] * 5 + [torch.float16] * 10)
    assert {g.layer_dtype(L, cpu) for L in g.layers} == {torch.float32}
    cfg = Config()
    cfg.stylegan3.num_fp16_res = 0
    g32 = sg3.Generator.from_config(cfg)
    assert {g32.layer_dtype(L, cuda) for L in g32.layers} == {torch.float32}
    cfg = Config()
    cfg.train_params.compute_dtype = "bfloat16"
    with pytest.raises(ValueError, match="num_fp16_res"):
        sg3.Generator.from_config(cfg)


def test_init_is_nvlabs_init():
    """Affine biases 1, the input's affine the identity, unit
    magnitude_ema, frequencies inside the input's band; the tree holds
    the state dict's keys."""
    g = sg3.Generator.from_config(_tiny_cfg())
    p = g.init(torch.Generator().manual_seed(1), device="cpu")
    syn = p["synthesis"]
    assert torch.equal(syn["input"]["affine"]["bias"],
                       torch.tensor([1.0, 0.0, 0.0, 0.0]))
    assert not syn["input"]["affine"]["weight"].any()
    assert float(syn["input"]["freqs"].norm(dim=1).max()) <= 2.0
    for L in g.layers:
        q = syn[L.spec.name]
        assert torch.equal(q["affine"]["bias"],
                           torch.ones(L.spec.in_channels))
        assert float(q["magnitude_ema"]) == 1.0
    sd = ref.init(dataclasses.asdict(StyleGAN3Params(**TINY)),
                  torch.Generator().manual_seed(1), "cpu")
    tree = g.params_from_state_dict(sd, device="cpu")

    def keys(t, pre=""):
        return sorted(k for a, v in t.items() for k in (
            keys(v, pre + a + ".") if isinstance(v, dict) else [pre + a]))

    assert keys(tree) == keys(p) == sorted(sd)


def test_shipped_yaml_pair():
    cfg = load_config("configs/model/stylegan3_t_ffhq1024.yaml",
                      "configs/test/stylegan3_1024.yaml")
    assert cfg.stylegan3 == StyleGAN3Params()
    assert cfg.train_params.compute_dtype == "float32"
    assert (cfg.task.height, cfg.task.width, cfg.task.batch_size) == (
        1024, 1024, 16)
    assert math.isclose(cfg.stylegan3.first_stopband, 2 ** 2.1)


def test_cli_writes_pngs(tmp_path):
    """python -m spgan_tpu_torch.infer with a tiny StyleGAN3 yaml pair:
    the manager and the image engine render two batches of 2 and write
    their 64x64 PNGs."""
    from spgan_tpu_torch.infer.__main__ import main
    from spgan_tpu_torch.infer.managers import ImageGenerationManager
    from spgan_tpu_torch.utils.png import read_png

    model = tmp_path / "m.yaml"
    model.write_text(
        'train_params:\n  g_arch: "spgan_tpu_torch.models.stylegan3.'
        'Generator"\nstylegan3:\n'
        + "".join(f"  {k}: {v}\n" for k, v in TINY.items()))
    test = tmp_path / "t.yaml"
    test.write_text('task_manager: "spgan_tpu_torch.infer.managers.'
                    'ImageGenerationManager"\nheight: 64\nwidth: 64\n'
                    'batch_size: 2\nnum_gen: 4\n')
    out = tmp_path / "out"
    mgr = main(["--model-config", str(model), "--test-config", str(test),
                "--device", "cpu", "--save-root", str(out), "--seed", "5"])
    assert isinstance(mgr, ImageGenerationManager)
    files = sorted(p.name for p in out.iterdir())
    assert files == [f"{i:06d}.png" for i in range(4)]
    img = read_png((out / "000003.png").read_bytes())
    assert img.shape == (64, 64, 3) and img.dtype == np.uint8
    assert len(np.unique(img)) > 16


def test_filtered_lrelu_in_batch_chunks(monkeypatch):
    """A batch whose upsampled tensor passes MAX_ELEMENTS (32-bit indexing
    of PyTorch's depthwise convolutions) runs in chunks of samples, with
    the same values."""
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((5, 12, 12, 3), generator=gen)
    b = torch.randn((3,), generator=gen)
    scale = torch.rand((5, 3), generator=gen) + 0.5
    fu = fl.design_lowpass_filter(24, 3.0, 4.0, 32.0)
    fd = fl.design_lowpass_filter(12, 4.0, 3.0, 16.0)
    kw = dict(up=4, down=2, padding=(-6, -9, -6, -9), clamp=4.0)
    whole = fl.filtered_lrelu(x, fu, fd, b, scale, **kw)
    monkeypatch.setattr(fl, "MAX_ELEMENTS", 2 * 3 * 100 * 100)
    chunked = fl.filtered_lrelu(x, fu, fd, b, scale, **kw)
    assert torch.equal(chunked, whole)
