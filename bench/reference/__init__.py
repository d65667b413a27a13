"""Plain PyTorch versions of what a training cell's step computes, written
from the algorithms' and models' equations; nothing here imports the
program."""
