"""engine.launches_per_image: device operations in the traced stretch per
image rendered there."""


def read(records):
    try:
        return records["n_kernels"] / records["traced_images"]
    except (KeyError, ZeroDivisionError):
        return None
