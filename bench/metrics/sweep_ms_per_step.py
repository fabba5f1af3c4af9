"""Device span of the sweep steps (the ``grafs::`` ranges on the device
timeline, first operation to last) per step, in ms."""


def read(run):
    t = run.trace
    if not t or not t["steps"] or t["step_device_s"] <= 0:
        return None
    return t["step_device_s"] / t["steps"] * 1e3
