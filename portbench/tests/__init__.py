"""The benchmark's CPU tests.

tiny.py stands each cell of the manifest in for the tiny cell of its loop
("render" or "train") when it builds the tiny manifest's metric lists.
Cells of the other loops (render_spans, render_sharded) have no tiny twin
there, and are tested on their own (tests/test_portbench_p197.py,
tests/test_portbench_sharded.py): `tiny.make_root` is wrapped here to
leave them out of those lists.  The wrap lives in this file so that it
holds wherever tiny is imported, in a test's fresh process too."""
from __future__ import annotations

import functools

from portbench import harness
from portbench.tests import tiny

TINY_LOOPS = ("render", "train")


def _tiny_cells_only(manifest: dict) -> dict:
    """The manifest with every metric's `workloads` list held to the cells
    whose loop tiny.py has a tiny cell of."""
    keep = {c["name"] for c in manifest["workloads"]
            if harness.load_data("traffic", c["traffic"])["loop"]
            in TINY_LOOPS}
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w in keep]
    return manifest


def _wrap(make_root):
    @functools.wraps(make_root)
    def wrapped(*args, **kwargs):
        load = harness.load_manifest
        harness.load_manifest = lambda *a, **k: _tiny_cells_only(load(*a, **k))
        try:
            return make_root(*args, **kwargs)
        finally:
            harness.load_manifest = load
    return wrapped


tiny.make_root = _wrap(tiny.make_root)
