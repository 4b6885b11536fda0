"""The plain reference the benchmark judges the program against: a frozen
copy of the program's plain PyTorch versions (spgan/), float32 with TF32
off, and the cells' comparisons.  Imports nothing of the program."""
