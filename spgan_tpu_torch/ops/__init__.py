"""StyleGAN2-style op library, NHWC (counterpart of spgan_tpu/ops: the
same exports)."""
from spgan_tpu_torch.ops.linear import (  # noqa: F401
    EqualLinear,
    EqualConv2d,
    fused_leaky_relu,
    pixel_norm,
    scaled_leaky_relu,
)
from spgan_tpu_torch.ops.upfirdn import (  # noqa: F401
    make_kernel,
    upfirdn2d,
    blur,
    Blur,
    Upsample,
    Downsample,
)
from spgan_tpu_torch.ops.modulated import (  # noqa: F401
    ModulatedConv2d,
    StyledConv,
    ToRGB,
    NoiseInjection,
    ConstantInput,
)
from spgan_tpu_torch.ops.grid_sample import (  # noqa: F401
    bilinear_grid_sample,
    st_grid_sample_3x3,
)
from spgan_tpu_torch.ops.spatial import (  # noqa: F401
    ConvSpec,
    calc_in_spatial_size,
    calc_out_spatial_size,
    out_size_chain,
    in_size_chain,
)
