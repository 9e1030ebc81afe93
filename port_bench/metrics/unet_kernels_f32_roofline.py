"""K2 conv3x3_gemm and K5 up_concat_conv in float32 (their CUDA-core
kernel) in the fusion's UNet forwards: bounds over device time."""
from port_bench.metrics.lib import roofline
from port_bench.roofline.sites import unet_sites


def read(run):
    c, n = run.cell.config, run.counts
    u = c["unet"]
    sites = unet_sites(u["model"], u["base_c"], c["unet_batch"], tuple(n["bucket"]), "float32")
    return roofline(run, ("conv3x3_gemm", "up_concat_conv"), sites, "float32", "unet_forwards")
