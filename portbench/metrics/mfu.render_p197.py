"""mfu.render_p197: the whole generate's share of the chip's peak with the
197-pixel patch plan, in %: mfu.render's reader, on the FLOPs of a
panorama at the configuration's own plan, which loops/render_spans.py
writes (flops_plans.py)."""
from pathlib import Path

from portbench import harness

read = harness.load_metric("mfu.render", Path(__file__).parent.parent).read
