"""device_idle.render: 1 - the device's busy time a batch in the traced
stretch (the union of its operations' intervals) over the wall time a
batch in the untraced window, in %."""


def read(records):
    try:
        busy = records["busy_s"] / records["traced_images"]
        wall = records["untraced_s"] / records["untraced_images"]
        return 100.0 * (1.0 - busy / wall)
    except (KeyError, ZeroDivisionError):
        return None
