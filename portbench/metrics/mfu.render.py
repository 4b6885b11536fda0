"""mfu.render: the whole generate's share of the chip's peak, in %: the
benchmark's FLOPs of a rendered image (flops.py) times the images per
second of the untraced window, over the peak of the cell's dtype."""


def read(records):
    try:
        rate = records["untraced_images"] / records["untraced_s"]
        return 100.0 * records["flops_per_image"] * rate / records["peak_flops"]
    except (KeyError, ZeroDivisionError):
        return None
