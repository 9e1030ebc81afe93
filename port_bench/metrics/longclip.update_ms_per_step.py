"""The update (AdamW and the logit-scale clamp) in host ms per step:
``longclip.update``'s self time."""
from port_bench.step_table import self_ms_per_step


def read(run):
    return self_ms_per_step("longclip.update")
