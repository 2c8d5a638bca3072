"""Set-up: from the start of the process (imports, CUDA start, the draw, the
port's build and pack, the warm-up) to the start of the window."""


def read(run):
    return run.setup_s
