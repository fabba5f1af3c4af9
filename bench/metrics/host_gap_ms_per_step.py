"""Traced window's time with the device idle, per sweep step (the
``grafs::pull`` and ``grafs::push`` ranges), in ms."""


def read(run):
    t = run.trace
    if not t or not t["steps"] or t["busy_s"] <= 0:
        return None
    return (t["window_s"] - t["busy_s"]) / t["steps"] * 1e3
