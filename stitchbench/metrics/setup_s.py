"""setup_s: from the process's start to the window's start (host clock):
imports, the kernel build or load, making the project, the Stitcher and
the warm-up project."""


def read(run):
    return run.setup_s
