"""Device memory held when the window opens above what was held before the
program built the graph: the graph, its layouts and the service's memo of
warm-up answers, in GiB."""


def read(run):
    b = run.graph_resident_bytes
    return b / 2 ** 30 if b > 0 else None
