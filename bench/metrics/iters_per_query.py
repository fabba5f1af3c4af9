"""Fixpoint iterations per answered query over the window: the service's
``total_iterations`` (the longest slot's iterations of each launch) or the
solo engine's ``ExecStats.iterations``, over the answers."""


def read(run):
    c = run.counters
    if not c.get("answers"):
        return None
    return c["iterations"] / c["answers"]
