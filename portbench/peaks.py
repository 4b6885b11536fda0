"""The chip's published peaks (NVIDIA H100 SXM data sheet, dense, at the
700 W power limit), and the card's name and power limit as read on the
run's machine.  A card set below 700 W runs slower under load: the limit
is printed beside every share of a peak."""
from __future__ import annotations

import shutil
import subprocess

PEAK_FLOPS = {
    "bfloat16": 989e12,      # tensor cores, dense
    "float32": 67e12,        # outside the tensor cores (TF32 off)
}
PEAK_BYTES_PER_S = 3.35e12   # HBM3


def power_limit_w() -> float | None:
    """The card's power limit in watts from nvidia-smi, or None."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run(
            [exe, "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (subprocess.SubprocessError, ValueError, IndexError, OSError):
        return None
