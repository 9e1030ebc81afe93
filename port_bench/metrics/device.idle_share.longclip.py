"""Idle share of the device in the Long-CLIP fine-tune window."""
from port_bench.metrics.lib import idle_share


def read(run):
    return idle_share(run)
