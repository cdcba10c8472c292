"""setup_s: seconds from the process's start to the window's start (imports,
the kernel libraries built or loaded, the data, one warm-up call)."""


def read(run):
    return run.setup_s
