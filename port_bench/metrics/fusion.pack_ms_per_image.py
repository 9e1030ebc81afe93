"""Host copies that pack both branches' batches, in ms per image: the self
time of ``fusion.clip.pack`` and ``fusion.unet.pack``."""
from port_bench.program_table import self_ms_per_image


def read(run):
    return self_ms_per_image("fusion.clip.pack", "fusion.unet.pack")
