"""Device kernels per Long-CLIP train step in the traced window."""
from port_bench.metrics.lib import launches_per


def read(run):
    return launches_per(run, "steps")
