"""train.reg_iter_ms: the mean of a cycle's regularised iterations (PPL,
and R1 with PPL), each ended by a synchronise, in a cycle run untraced
after the window."""


def read(records):
    t = records.get("reg_iter_s")
    return 1e3 * sum(t) / len(t) if t else None
