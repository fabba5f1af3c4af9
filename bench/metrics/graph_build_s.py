"""Host clock from the program's graph build (``structure.from_edges``)
through its validation, layout builds, library loads and the warm-up."""


def read(run):
    return run.graph_build_s
