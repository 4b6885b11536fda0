"""filtered_lrelu_roofline: StyleGAN3's filtered LeakyReLU's least time at
the HBM's bandwidth (its byte bound an image, flops_sg3.py: each layer's
conv output read once and its output written once, at the layer's dtype,
times the images of the traced stretch) over the device seconds under the
program's span spgan.sg3.filtered_lrelu there, in %.  The bound counts
the op's work whatever implements it.  Silent without the program's
spans."""
from portbench import peaks

SPAN = "spgan.sg3.filtered_lrelu"


def read(records):
    att = records.get("spans")
    try:
        t = att["names"][SPAN]["device_s"]
        work = records["filtered_lrelu_bytes"] * records["traced_images"]
    except (KeyError, TypeError):
        return None
    if t <= 0:
        return None
    return 100.0 * work / peaks.PEAK_BYTES_PER_S / t
