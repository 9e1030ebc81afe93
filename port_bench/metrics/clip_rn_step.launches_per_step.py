"""Device kernels per RN fine-tune step in the traced window, the
recomputed blocks' launches included."""
from port_bench.metrics.lib import launches_per


def read(run):
    return launches_per(run, "steps")
