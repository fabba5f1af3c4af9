"""The traced window: ``torch.profiler`` over the first ``TRACE_S`` seconds
of the window (so that reading the trace stays short), reduced in memory
to the numbers the per-layer readers take (nothing is written to disk).

Device busy time is the union of the device's operations (kernels,
copies, fills) on the timeline, so that overlapping operations count once.
The program marks each sweep step with a ``grafs::pull`` or
``grafs::push`` range (``kernels/ops.py``): the host-side ranges count the
steps, and their device-side spans, from a step's first operation to its
last, give the steps' device time.  Each idle gap between device
operations is named by the innermost host range or operation that was
running at its middle.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

import torch

TRACE_S = 10.0
STEP_RANGES = ("grafs::pull", "grafs::push")
RANGE_PREFIXES = ("grafs::", "bench::")
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx")
TOP = 10
_NAME_CHARS = 120
_GAP_SCAN = 4000          # host events looked back over to name one gap


def span(name: str):
    """A harness range, recorded only while a profiler records."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


class Tracer:
    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.device = device
        self._prof = profile(activities=acts)
        self.window_s = 0.0
        self.open = False

    def start(self) -> None:
        self._sync()
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        self._events = None
        if self.device.type == "cuda":
            self._events = [torch.cuda.Event(enable_timing=True)
                            for _ in range(2)]
            self._events[0].record()
        self.open = True

    def stop(self) -> None:
        if not self.open:
            return
        if self._events is not None:
            self._events[1].record()
        self._sync()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        self.open = False

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def summary(self) -> dict:
        out = summarize(self._prof.profiler.kineto_results.events(),
                        self.window_s)
        if self._events is not None:
            # the cross-check: the window on the device's own clock
            out["event_window_s"] = \
                self._events[0].elapsed_time(self._events[1]) / 1e3
        return out


def _union(intervals: list) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _name_gaps(gaps: list, host: list) -> dict:
    """Idle seconds by the innermost host event running at each gap's
    middle (the latest-starting one that contains it)."""
    host.sort()
    starts = [h[0] for h in host]
    by_name: dict = defaultdict(float)
    for s, e in gaps:
        mid = (s + e) / 2
        name = "host: no range"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - _GAP_SCAN, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        by_name[name[:_NAME_CHARS]] += (e - s) / 1e9
    return by_name


def _top(by_name: dict) -> list:
    return [[k, v] for k, v in sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:TOP]]


def _is_range(ev) -> bool:
    """A ``record_function`` range (on the host, or its span on the
    device's timeline), not an operation."""
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        return kind() in ("user_annotation", "gpu_user_annotation")
    return ev.name().startswith(RANGE_PREFIXES)


def summarize(events, window_s: float) -> dict:
    from torch.autograd import DeviceType
    device_ops, step_spans, host = [], [], []
    steps = launches = 0
    for ev in events:
        name = ev.name()
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            if not _is_range(ev):
                device_ops.append((start, end, name))
            elif name in STEP_RANGES:
                step_spans.append(end - start)
        else:
            host.append((start, end, name))
            steps += name in STEP_RANGES
            launches += name in LAUNCHES
    merged = _union([(s, e) for s, e, _ in device_ops])
    busy_s = sum(e - s for s, e in merged) / 1e9
    op_s: dict = defaultdict(float)
    for s, e, name in device_ops:
        op_s[name[:_NAME_CHARS]] += (e - s) / 1e9
    gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
    gaps.sort(key=lambda g: g[0] - g[1])
    return {"window_s": window_s, "busy_s": busy_s,
            "steps": steps,
            "kernels": sum(not n.startswith(("Memcpy", "Memset"))
                           for _, _, n in device_ops),
            "launches": launches,
            "step_device_s": sum(step_spans) / 1e9,
            "device_ops": _top(op_s),
            "idle_gaps": _top(_name_gaps(gaps[:2000], host))}
