"""K6 csa_attention in float32 (ffma_f32) in the Long-CLIP step: the last
vision block's CSA, once a step; the sum of its calls' bounds over its
device time."""
from port_bench.metrics.lib import roofline
from port_bench.roofline.sites import csa_sites


def read(run):
    c = run.cell.config["clip"]
    seq = (c["resolution"] // c["patch"]) ** 2 + 1
    sites = csa_sites(run.counts["batch"], seq, c["vision_width"], c["vision_width"] // 64, 1,
                      "float32")
    return roofline(run, ("csa_attention",), sites, "float32", "steps")
