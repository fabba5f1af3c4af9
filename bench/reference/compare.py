"""The comparison that decides ``correct``.

Each answer is compared with the reference's, vertex by vertex, by value
(every answer here is exact, so the limit is 0): ``wrong_vertices`` counts
the vertices, over every compared answer, whose value differs.
``unanswered`` counts requests sent in the window that no answer came back
for, the drain after the window included.  Both numbers have the limit 0.
"""
from __future__ import annotations

import numpy as np

LIMITS = {"wrong_vertices": 0, "unanswered": 0}


def wrong_vertices(got, want) -> int:
    got = np.asarray(got)
    want = np.asarray(want)
    if got.shape != want.shape or got.dtype != want.dtype:
        return int(want.size)
    return int(np.count_nonzero(got != want))


def verdict(numbers: dict) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)
