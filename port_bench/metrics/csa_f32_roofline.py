"""K6 csa_attention in float32 (ffma_f32) in the CLIPSeg forwards: the sum
of its calls' bounds over its device time."""
from port_bench.metrics.lib import roofline
from port_bench.roofline.sites import csa_sites


def read(run):
    c = run.cell.config
    v = c["clipseg"]
    seq = (c["clip_size"] // v["patch"]) ** 2 + 1
    sites = csa_sites(c["clip_batch"], seq, v["width"], v["width"] // 64,
                      max(v["extract_layers"]) + 1, "float32")
    return roofline(run, ("csa_attention",), sites, "float32", "clip_forwards")
