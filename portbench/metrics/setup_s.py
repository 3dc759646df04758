"""setup_s: seconds from the process's start to the window's start
(imports, CUDA start, the kernel library, inputs, host build, warm-up)."""


def read(run):
    return run.setup_s
