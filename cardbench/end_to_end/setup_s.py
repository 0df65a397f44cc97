"""Seconds from the process's start to the window's first request: imports,
the kernel library's build or load, weights, images, plans, graph captures
and warm-up."""


def read(run):
    return run.setup_s
