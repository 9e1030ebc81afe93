"""Host-to-device upload volume in MB (1e6 bytes) per image: the counter
``fusion.h2d_bytes``."""
from port_bench.program_table import per_image


def read(run):
    v = per_image("fusion.h2d_bytes")
    return None if v is None else v / 1e6
