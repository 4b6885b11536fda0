"""generator.elementwise_share: the share of the device's operation time
in the traced stretch spent in elementwise and reduction kernels, by the
name patterns below, in %."""

PATTERNS = ("elementwise", "reduce_kernel", "CatArrayBatchedCopy",
            "index_elementwise", "gather", "scatter")


def read(records):
    kernels = records.get("kernels")
    if not kernels:
        return None
    total = sum(v[0] for v in kernels.values())
    hit = sum(v[0] for k, v in kernels.items()
              if any(p in k for p in PATTERNS))
    return 100.0 * hit / total if total > 0 else None
