"""sg3.filtered_lrelu_share: the device seconds of StyleGAN3's filtered
LeakyReLU (the program's span spgan.sg3.filtered_lrelu, L0-L13) over the
device seconds of the whole generate (spgan.engine.generate and every span
inside it), in the traced stretch, in %.  Silent without the program's
spans."""

SPAN = "spgan.sg3.filtered_lrelu"
ROOT = "spgan.engine.generate"


def read(records):
    att = records.get("spans")
    if not att:
        return None
    part = att["names"].get(SPAN, {}).get("device_s", 0.0)
    whole = att["roots"].get(ROOT, {}).get("device_s", 0.0)
    if part <= 0 or whole <= 0:
        return None
    return 100.0 * part / whole
