"""The masks' readbacks, in ms per image: ``fusion.readback``'s self time,
mostly the host waiting for both branches on the device."""
from port_bench.program_table import self_ms_per_image


def read(run):
    return self_ms_per_image("fusion.readback")
