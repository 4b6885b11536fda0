"""Training before g_path_start: loops/train.py, unchanged, under a name of
its own.  portbench/tests' tiny manifest maps each cell of the `train`
loop onto its tiny training cell by name, and knows only
train-f32-lazyreg; a cell of this loop is left out of it, as the
render_spans and render_sharded cells are."""
from portbench.loops.train import run  # noqa: F401
