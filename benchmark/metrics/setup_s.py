"""Set-up seconds: process start to the window's first step (imports,
CUDA start, the kernel library's load or build, inputs, the program's
build and the warm-up of the cell's shapes)."""


def read(run):
    return run.setup_s
