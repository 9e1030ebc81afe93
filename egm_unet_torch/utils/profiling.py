"""Timing and tracing helpers (port of ``egm_unet_tpu/utils/profiling.py``).

- ``device_synchronized(device)``: the wall clock after the device's queued
  work has finished (``torch.cuda.synchronize`` on a CUDA device; nothing to
  wait for on the CPU).
- ``span(name)`` and ``count(name, n)``: the program's spans and counters.
  They record only while a ``torch.profiler`` session is active or inside a
  ``recording()`` block; otherwise a span costs one flag check and returns
  a shared null context, and a counter returns at once.  A recorded span
  enters ``torch.profiler.record_function(name)``, so it lands in the
  profiler's timeline beside the device's kernels and copies, and adds its
  host-clock duration to an in-memory table kept per name: ``count``,
  ``seconds``, ``self_seconds`` (its duration less the time its child spans
  cover) and ``parent`` (the enclosing span's name on the same thread, or
  None).  A counter adds ``n`` to ``value`` under its name in the same
  table.  ``table()`` returns a copy; ``reset_table()`` clears it.
- ``trace(logdir)``: ``torch.profiler`` around a block (the CPU, and the
  GPU when there is one), written to ``logdir`` as a Chrome trace
  (``trace.json``, the raw spans on the profiler's clock) and the span
  table of the block (``spans.json``); the counterpart of
  ``jax.profiler.start_trace``.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict

import torch
from torch.profiler import record_function

_profiler_enabled = torch.autograd._profiler_enabled
_lock = threading.Lock()  # the table and _forced; spans come from several threads
_table: Dict[str, dict] = {}
_forced = 0  # open recording() blocks
_local = threading.local()  # .stack: the open spans of this thread
_NULL = contextlib.nullcontext()


def device_synchronized(device=None) -> float:
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


class _Span:
    __slots__ = ("name", "fn", "t0", "children")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        self.children = 0.0
        self.t0 = time.perf_counter()
        self.fn = record_function(self.name)
        self.fn.__enter__()
        return self

    def __exit__(self, *exc):
        self.fn.__exit__(*exc)
        dt = time.perf_counter() - self.t0
        stack = _local.stack
        stack.pop()
        parent = stack[-1] if stack else None
        if parent is not None:
            parent.children += dt
        with _lock:
            rec = _table.get(self.name)
            if rec is None:
                rec = _table[self.name] = {"count": 0, "seconds": 0.0, "self_seconds": 0.0,
                                           "parent": parent.name if parent else None}
            rec["count"] += 1
            rec["seconds"] += dt
            rec["self_seconds"] += dt - self.children
        return False


def span(name: str):
    """A context manager that records the block as the span ``name`` while
    recording is on, and does nothing otherwise."""
    if _forced or _profiler_enabled():
        return _Span(name)
    return _NULL


def count(name: str, n) -> None:
    """Add ``n`` to the counter ``name`` while recording is on."""
    if _forced or _profiler_enabled():
        with _lock:
            rec = _table.setdefault(name, {"value": 0})
            rec["value"] += n


@contextlib.contextmanager
def recording():
    """Record spans and counters inside the block, without a profiler."""
    global _forced
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1


def table() -> Dict[str, dict]:
    """A copy of the span and counter table."""
    with _lock:
        return {k: dict(v) for k, v in _table.items()}


def reset_table() -> None:
    with _lock:
        _table.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; yields the ``torch.profiler.profile`` object and
    writes ``<logdir>/trace.json`` and ``<logdir>/spans.json`` (the span
    table, cleared when the block starts) when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    reset_table()
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump(table(), f, indent=1, sort_keys=True)
