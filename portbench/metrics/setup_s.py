"""``setup_s``: seconds from the process's start to the window's, the
host's clock: imports, the inputs drawn from the seed, the lake written,
the kernel built and every shape of the window warmed."""


def read(run):
    return run.setup_s
