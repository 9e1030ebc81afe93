"""The RN fine-tune step's model FLOPs (3x both towers' forward
convolutions and products, the text tower twice, per image trained; the
recomputed blocks not counted) per second over the float32 CUDA-core
peak."""
from port_bench.metrics.lib import mfu
from port_bench.roofline.clip_rn_flops import clip_rn_triple_flops


def read(run):
    c = run.cell.config
    return mfu(run, clip_rn_triple_flops(**c["clip"]), "images", c["dtype"])
