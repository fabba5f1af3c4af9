"""The service's answers per batch launch over the window
(``batch_completed / batch_launches``)."""


def read(run):
    c = run.counters
    if not c.get("launches"):
        return None
    return c["answers"] / c["launches"]
