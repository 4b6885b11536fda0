"""engine.all_gather_share: the device and device-idle seconds under the
sharded engine's all-gather of the patches (the program's span
spgan.engine.all_gather) over those under the whole generate
(spgan.engine.generate and every span inside it), in rank 0's traced
stretch, in %.  Silent without the program's spans."""

SPAN = "spgan.engine.all_gather"
ROOT = "spgan.engine.generate"


def _seconds(row):
    return row.get("device_s", 0.0) + row.get("idle_s", 0.0)


def read(records):
    att = records.get("spans")
    if not att or SPAN not in att["names"]:
        return None
    whole = _seconds(att["roots"].get(ROOT, {}))
    if whole <= 0:
        return None
    return 100.0 * _seconds(att["names"][SPAN]) / whole
