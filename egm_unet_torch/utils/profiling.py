"""Timing and tracing helpers (port of ``egm_unet_tpu/utils/profiling.py``).

- ``device_synchronized(device)``: the wall clock after the device's queued
  work has finished (``torch.cuda.synchronize`` on a CUDA device; nothing to
  wait for on the CPU).
- ``StepTimer``: per-phase accumulator of host-clock durations with an
  FPS-style summary.
- ``trace(logdir)``: ``torch.profiler`` around a block (the CPU, and the
  GPU when there is one), written to ``logdir`` as a Chrome trace
  (``trace.json``); the counterpart of ``jax.profiler.start_trace``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


def device_synchronized(device=None) -> float:
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; yields the ``torch.profiler.profile`` object and
    writes ``<logdir>/trace.json`` when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Accumulates named phase durations; prints an FPS-style summary
    (the reference's predict.py: FPS = 1 / (total / count))."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        yield
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def fps(self, name: str = "step") -> float:
        if self.counts[name] == 0:
            return 0.0
        return self.counts[name] / self.totals[name]

    def summary(self) -> str:
        return "  ".join(
            f"{k}: {self.totals[k] / max(self.counts[k], 1) * 1e3:.2f}ms"
            for k in sorted(self.totals))
