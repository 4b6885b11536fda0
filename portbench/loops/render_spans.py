"""Offline panorama rendering (loops/render.py, unchanged) with the
program's tracer on over the traced stretch: `portbench.spans.with_spans`
around the stretch's profile, so the program's spans and counters are
joined with the device timeline there and only there.  The untraced
window runs with the tracer off, as in the render loop.

The reference's ToRGB calibration renders one panorama of the cell's own
size (reference.render.calibrate on `calibration_task`), not its fixed
384x768: at the 197-pixel patch plan a 384x768 close-loop lattice has 4
columns of 6 latents, narrower than the 35-latent SS window it wraps.
At 768x1536 the 197 plan renders the lattice that 384x768 gives the 101
plan, the calibration of the 101-plan cells.

The loop's `flops_per_image` is the configuration's own plan's count
(flops_plans.image_flops, which reads patch_size), where the render loop
writes the 101-pixel plan's (flops.image_flops).

Records added to the render loop's (the readers return None when they are
missing, as on a program without the tracer's spans):

  spans     the join (`spans.attribute`): {"names": {span: {count,
            host_s, device_s, idle_s}}, "roots": {...}, "device_s",
            "idle_s", "unlinked"}
  counters  the program's counters over the traced stretch
"""
from __future__ import annotations

from portbench import flops_plans, harness, spans, trace
from portbench.loops import render
from portbench.reference import render as ref_render


def calibration_task(traffic: dict) -> dict:
    """One panorama of the traffic's size, in its chunks."""
    task = traffic["task"]
    return {"height": task["height"], "width": task["width"],
            "batch_size": 1, "patch_chunk": task["patch_chunk"]}


def run(ctx: harness.Context) -> harness.Outcome:
    out: dict = {}
    profile, task = trace.profile, ref_render.CALIBRATION_TASK
    trace.profile = spans.with_spans(profile, out)
    ref_render.CALIBRATION_TASK = calibration_task(ctx.traffic)
    try:
        outcome = render.run(ctx)
    finally:
        trace.profile, ref_render.CALIBRATION_TASK = profile, task
    outcome.records["flops_per_image"] = flops_plans.image_flops(
        ctx.config, ref_render.rendered_patches(ctx.config, ctx.traffic))
    if "table" in out:
        outcome.records["spans"] = out["table"]
        outcome.records["counters"] = out["counters"]
    return outcome
