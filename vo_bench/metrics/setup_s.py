"""setup_s: process start to the window's start (import, CUDA context,
kernel load, routes rendered, warm session)."""


def read(run):
    return run.setup_s
