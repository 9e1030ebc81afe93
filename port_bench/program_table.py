"""What the readers of the program's span and counter table share
(``egm_unet_torch.utils.profiling.table()``, filled while the traced
window's profiler runs).  Each value is per image of that window, from the
counter ``fusion.images``.  None where the program has no table, or the
table lacks a span or counter, or counted no image: a value is never made
up as 0."""

from __future__ import annotations

from typing import Optional


def fusion_table() -> Optional[dict]:
    """The table, where it counted images; else None."""
    try:
        from egm_unet_torch.utils.profiling import table
    except ImportError:
        return None
    tab = table()
    if not tab.get("fusion.images", {}).get("value"):
        return None
    return tab


def self_ms_per_image(*spans: str) -> Optional[float]:
    """The spans' self time summed, in ms per image."""
    tab = fusion_table()
    if tab is None or any("self_seconds" not in tab.get(s, {}) for s in spans):
        return None
    return 1e3 * sum(tab[s]["self_seconds"] for s in spans) / tab["fusion.images"]["value"]


def per_image(counter: str) -> Optional[float]:
    """The counter's value per image."""
    tab = fusion_table()
    if tab is None or "value" not in tab.get(counter, {}):
        return None
    return tab[counter]["value"] / tab["fusion.images"]["value"]
