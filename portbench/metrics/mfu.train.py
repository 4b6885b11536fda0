"""mfu.train: the whole training iteration's share of the chip's peak, in
%: the benchmark's FLOPs of a cycle of the lazy schedule (flops.py, its
backward convention) over the untraced window's seconds a cycle and the
peak of the cell's dtype."""


def read(records):
    try:
        cycle_s = records["untraced_s"] / records["untraced_cycles"]
        return 100.0 * records["flops_per_cycle"] / cycle_s / records["peak_flops"]
    except (KeyError, ZeroDivisionError):
        return None
