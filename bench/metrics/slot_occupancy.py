"""Mean share of a batch lane's slots live in each launch over the window,
in percent (the service's ``occupancy``)."""


def read(run):
    c = run.counters
    if not c.get("launches"):
        return None
    return 100.0 * c["occupied_slots"] / c["launches"]
