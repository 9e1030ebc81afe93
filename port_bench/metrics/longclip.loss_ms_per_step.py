"""The loss (L2 norms, the PCA's SVD, the similarities and cross-entropies)
in host ms per step: ``longclip.loss``'s self time, mostly the host waiting
at the SVD for the forward on the device."""
from port_bench.step_table import self_ms_per_step


def read(run):
    return self_ms_per_step("longclip.loss")
