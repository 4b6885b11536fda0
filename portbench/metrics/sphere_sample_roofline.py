"""sphere_sample_roofline: the tap sampler's least time at the HBM's
bandwidth (each input byte read once, each output byte written once, from
each launch's shapes in the traced stretch) over the profiler's device
time of the kernels named here, in %."""
from portbench import flops, peaks

KERNELS = ("sphere_sample_taps_kernel",)


def read(records):
    launches = records.get("sphere_sample")
    kernels = records.get("kernels", {})
    t = sum(v[0] for k, v in kernels.items() if any(n in k for n in KERNELS))
    if not launches or t <= 0:
        return None
    return 100.0 * flops.sphere_sample_bytes(launches) / peaks.PEAK_BYTES_PER_S / t
