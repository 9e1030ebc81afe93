"""K1 mca_fused, K2 conv3x3_gemm and K5 up_concat_conv together in bf16:
the sum of their calls' bounds over their device time."""
from port_bench.metrics.lib import roofline
from port_bench.roofline.sites import unet_sites


def read(run):
    c, n = run.cell.config, run.counts
    sites = unet_sites(c["model"], c["base_c"], n["batch"], tuple(n["hw"]), "bfloat16")
    return roofline(run, ("mca_fused", "conv3x3_gemm", "up_concat_conv"), sites,
                    "bfloat16", "forwards")
