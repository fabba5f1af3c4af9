"""The least time the traced window's answers need at the card's HBM
bandwidth (``reference.roofline``: bytes counted from the reference's own
reach, never from the program's layouts) over the device's busy time, in
percent."""
from reference import roofline


def read(run):
    t = run.trace
    peak = roofline.PEAK_BYTES_PER_S.get(run.device_name)
    if not t or t["busy_s"] <= 0 or not run.needed_bytes or not peak:
        return None
    return 100.0 * run.needed_bytes / peak / t["busy_s"]
