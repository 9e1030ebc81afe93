"""The device trace of a measured window, reduced to what the readers and
the result line need: busy seconds (the union of device operations'
intervals inside the window), device time and launches by operation name,
and the longest idle gaps named by what the host was doing.

The window is the interval of a host span the harness records around the
measured loop (``WINDOW_SPAN``); without host events (``activities`` of the
device only) the whole trace is the window.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

SPAN_PREFIX = "bench."
WINDOW_SPAN = SPAN_PREFIX + "window"
COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events, window_us: Optional[tuple] = None) -> dict:
    """``events``: ``prof.events()`` of a ``torch.profiler`` session.
    Times in the result are seconds."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in events:
        tr = e.time_range
        if getattr(e, "is_user_annotation", False) or e.name.startswith(SPAN_PREFIX):
            # a host span's shadow on the device timeline, not an operation
            if e.device_type == DeviceType.CUDA:
                continue
        if e.device_type == DeviceType.CUDA:
            dev.append((tr.start, tr.end, e.name))
        elif e.device_type == DeviceType.CPU:
            host.append((tr.start, tr.end, e.name))
    if window_us is None:
        spans = [(s, e) for s, e, n in host if n == WINDOW_SPAN]
        if spans:
            window_us = spans[0]
        elif dev:
            window_us = (min(s for s, _, _ in dev), max(e for _, e, _ in dev))
        else:
            window_us = (0.0, 0.0)
    w0, w1 = window_us
    inside = [(max(s, w0), min(e, w1), n) for s, e, n in dev if e > w0 and s < w1]
    busy = _merge([(s, e) for s, e, _ in inside])
    busy_us = sum(e - s for s, e in busy)
    by_name: Dict[str, List[float]] = {}
    for s, e, n in inside:
        rec = by_name.setdefault(n, [0.0, 0])
        rec[0] += (e - s) / 1e6
        rec[1] += 1
    gaps = []
    prev = w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for g0, g1 in gaps[:10]:
        mid = 0.5 * (g0 + g1)
        cover = [(e - s, n) for s, e, n in host if s <= mid <= e and n != WINDOW_SPAN]
        label = min(cover)[1] if cover else ("host" if host else "unattributed")
        named.append([label, (g1 - g0) / 1e6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_us / 1e6,
        "by_name": {n: {"seconds": v[0], "count": v[1]} for n, v in by_name.items()},
        "launches": sum(v[1] for n, v in by_name.items() if not n.startswith(COPY_PREFIXES)),
        "device_ops": [[n, v[0]] for n, v in top],
        "idle_gaps": named,
    }


def kernel_seconds(summary: dict, names) -> tuple:
    """(seconds, launches) of the device operations whose name contains any
    of ``names``; each operation counted once."""
    secs, count = 0.0, 0
    for op, rec in summary["by_name"].items():
        if any(n in op for n in names):
            secs += rec["seconds"]
            count += rec["count"]
    return secs, count


class Tracer:
    """``with tracer.window():`` around the measured loop; off (``on`` is
    False) it does nothing."""

    def __init__(self, on: bool, cuda: bool = True):
        self.on, self.cuda = on, cuda
        self.summary: Optional[dict] = None

    @contextlib.contextmanager
    def window(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        if not self.on:
            yield
            return
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        with profile(activities=acts) as prof:
            with record_function(WINDOW_SPAN):
                yield
                if self.cuda:
                    torch.cuda.synchronize()
        self.summary = summarize(prof.events())
