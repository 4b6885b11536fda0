"""sphere_conv_roofline: the sphere convs' least time at the dtype's peak
(2*B*H*W*9*C*Cout a launch, from each launch's shapes in the traced
stretch) over the profiler's device time of the kernels named here, in %.
Silent when the traced stretch saw no launch or no such kernel."""
from portbench import flops

KERNELS = ("sphere_conv_bf16", "sphere_conv_f32")


def read(records):
    launches = records.get("sphere_conv")
    kernels = records.get("kernels", {})
    t = sum(v[0] for k, v in kernels.items() if any(n in k for n in KERNELS))
    if not launches or t <= 0:
        return None
    return 100.0 * flops.sphere_conv_flops(launches) / records["peak_flops"] / t
