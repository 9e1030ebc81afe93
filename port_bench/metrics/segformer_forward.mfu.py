"""The SegFormer forward's model FLOPs per second over the bf16
tensor-core peak."""
from port_bench.metrics.lib import mfu
from port_bench.roofline.segformer_flops import segformer_flops


def read(run):
    c = run.cell.config
    flops = segformer_flops(c["segformer"], c["num_labels"], tuple(run.counts["hw"]))
    return mfu(run, flops, "images", c["dtype"])
