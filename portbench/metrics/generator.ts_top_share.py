"""generator.ts_top_share: the device seconds of the texture synthesizer's
layers past the 101-pixel plan (the program's span
spgan.generator.ts_top: convs 9-10 of the 197 plan, its fourth sphere
skip conv and last ToRGB) over the device seconds of the whole generate
(spgan.engine.generate and every span inside it), in the traced stretch,
in %.  Silent without the program's spans (a program that lacks the span,
or a loop that does not join them)."""

SPAN = "spgan.generator.ts_top"
ROOT = "spgan.engine.generate"


def read(records):
    att = records.get("spans")
    if not att:
        return None
    top = att["names"].get(SPAN, {}).get("device_s", 0.0)
    whole = att["roots"].get(ROOT, {}).get("device_s", 0.0)
    if top <= 0 or whole <= 0:
        return None
    return 100.0 * top / whole
