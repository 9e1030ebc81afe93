"""What the readers of the Long-CLIP step's spans share: the program's table
(``egm_unet_torch.utils.profiling.table()``, filled while the traced
window's profiler runs), each value per step of that window from the
counter ``longclip.steps``.  None where the program has no table, or the
table lacks a span or the counter, or counted no step: a value is never
made up as 0."""

from __future__ import annotations

from typing import Optional


def self_ms_per_step(*spans: str) -> Optional[float]:
    """The spans' self time summed, in ms per step."""
    try:
        from egm_unet_torch.utils.profiling import table
    except ImportError:
        return None
    tab = table()
    steps = tab.get("longclip.steps", {}).get("value")
    if not steps or any("self_seconds" not in tab.get(s, {}) for s in spans):
        return None
    return 1e3 * sum(tab[s]["self_seconds"] for s in spans) / steps
