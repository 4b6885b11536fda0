"""device_idle.train: 1 - the device's busy time over the traced cycle
(the union of its operations' intervals) over the wall time of a cycle in
the untraced window, in %."""


def read(records):
    try:
        busy = records["busy_s"] / records["traced_cycles"]
        wall = records["untraced_s"] / records["untraced_cycles"]
        return 100.0 * (1.0 - busy / wall)
    except (KeyError, ZeroDivisionError):
        return None
