"""95th percentile, over every query sent in the window and answered (the
drain after the window included), of the time from the client's send to
its answer on the host (host clock)."""
import numpy as np


def read(run):
    lat = run.latencies_s
    return float(np.percentile(lat, 95)) * 1e3 if lat.size else None
