"""What the per-layer readers share.  Each reader returns None where its
run has nothing to read (no trace, no launch of its kernels), and the
harness then leaves the metric out; a share is never made up as 0."""

from __future__ import annotations

from typing import Optional

from port_bench.roofline import PEAK_FLOPS, kernel_names
from port_bench.roofline.sites import bound_of
from port_bench.trace import kernel_seconds


def idle_share(run) -> Optional[float]:
    """Percent of the traced window in which no device operation ran."""
    t = run.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def launches_per(run, unit_key: str) -> Optional[float]:
    """Device kernels (copies left out) per forward or step of the traced
    window: an exact count."""
    if not run.trace or not run.trace["launches"]:
        return None
    n = run.counts.get(unit_key)
    return float(run.trace["launches"]) / n if n else None


def mfu(run, flops_per_item: float, item_key: str, dtype: str) -> Optional[float]:
    """Percent of the dtype's peak: model FLOPs of the traced window's items
    over its seconds."""
    items, secs = run.counts.get(item_key), run.counts.get("seconds")
    if not items or not secs:
        return None
    return 100.0 * flops_per_item * items / secs / PEAK_FLOPS[dtype]


def roofline(run, operations, sites, dtype: str, unit_key: str) -> Optional[float]:
    """Percent: the sum of ``sites``' bounds (one forward's calls) times the
    traced window's forwards, over the device time of the kernels listed
    for ``operations``."""
    if not run.trace:
        return None
    secs, launches = kernel_seconds(run.trace, kernel_names(*operations))
    n = run.counts.get(unit_key)
    if not launches or not n or secs <= 0:
        return None
    return 100.0 * bound_of(sites, dtype) * n / secs
