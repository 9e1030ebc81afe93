"""The Long-CLIP step's model FLOPs (3x both towers' forward products, the
text tower twice, per image trained) per second over the float32 CUDA-core
peak."""
from port_bench.metrics.lib import mfu
from port_bench.roofline.longclip_flops import longclip_triple_flops


def read(run):
    c = run.cell.config
    return mfu(run, longclip_triple_flops(**c["clip"]), "images", c["dtype"])
