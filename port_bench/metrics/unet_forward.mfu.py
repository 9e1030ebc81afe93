"""The UNet forward's model FLOPs per second over the bf16 tensor-core peak."""
from port_bench.metrics.lib import mfu
from port_bench.roofline.flops import unet_flops


def read(run):
    c = run.cell.config
    flops = unet_flops(c["model"], c["base_c"], c["num_classes"], tuple(run.counts["hw"]))
    return mfu(run, flops, "images", c["dtype"])
