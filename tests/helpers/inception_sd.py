"""A synthetic InceptionV3 state dict in pytorch-fid's layout
(pt_inception-2015-12-05-*.pth): He-scale conv weights, random batchnorm
statistics, num_batches_tracked and the 1008-way fc head, from a numpy
RandomState.  The key names and shapes come from the JAX package's
tables."""
import numpy as np
import torch

from spgan_tpu.evalkit.inception import _BLOCK_DEFS, _block_param_shapes

STEM = [("Conv2d_1a_3x3", 3, 3, 3, 32), ("Conv2d_2a_3x3", 3, 3, 32, 32),
        ("Conv2d_2b_3x3", 3, 3, 32, 64), ("Conv2d_3b_1x1", 1, 1, 64, 80),
        ("Conv2d_4a_3x3", 3, 3, 80, 192)]


def pt_inception_state_dict(rng: np.random.RandomState) -> dict:
    sd = {}

    def conv_bn(prefix, kh, kw, cin, cout):
        fan_in = cin * kh * kw
        sd[f"{prefix}.conv.weight"] = torch.tensor(
            rng.randn(cout, cin, kh, kw).astype(np.float32)
            * np.float32(np.sqrt(2.0 / fan_in)))
        sd[f"{prefix}.bn.weight"] = torch.tensor(
            rng.uniform(0.5, 1.5, cout).astype(np.float32))
        sd[f"{prefix}.bn.bias"] = torch.tensor(
            (rng.randn(cout) * 0.1).astype(np.float32))
        sd[f"{prefix}.bn.running_mean"] = torch.tensor(
            (rng.randn(cout) * 0.1).astype(np.float32))
        sd[f"{prefix}.bn.running_var"] = torch.tensor(
            rng.uniform(0.5, 1.5, cout).astype(np.float32))
        sd[f"{prefix}.bn.num_batches_tracked"] = torch.tensor(0)

    for name, kh, kw, cin, cout in STEM:
        conv_bn(name, kh, kw, cin, cout)
    for bname, (kind, cin, extra) in _BLOCK_DEFS.items():
        k = kind[0] if kind in ("E1", "E2") else kind
        for pname, kh, kw, ci, co in _block_param_shapes(k, cin, extra):
            conv_bn(f"{bname}.{pname}", kh, kw, ci, co)
    sd["fc.weight"] = torch.tensor(
        (rng.randn(1008, 2048) * 0.05).astype(np.float32))
    sd["fc.bias"] = torch.tensor((rng.randn(1008) * 0.1).astype(np.float32))
    return sd
