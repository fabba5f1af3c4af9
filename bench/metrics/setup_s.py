"""Process start to the window's start: imports, CUDA start-up, graph
generation, the program's graph and layout builds, library loads (and
builds, on a checkout's first run) and the warm-up (host clock)."""


def read(run):
    return run.setup_s
