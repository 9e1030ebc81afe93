"""Host preprocessing (PIL resizes, both normalisations) in ms per image:
``fusion.preprocess``'s self time."""
from port_bench.program_table import self_ms_per_image


def read(run):
    return self_ms_per_image("fusion.preprocess")
