"""SegFormer's 52 spatial-reduction attention calls in bf16: the sum of
their bounds (``roofline/segformer_sites.py``) over the device time of the
kernels listed under ``roofline/names/segformer_attention/``."""
from port_bench.metrics.lib import roofline
from port_bench.roofline.segformer_sites import segformer_attention_sites


def read(run):
    c, n = run.cell.config, run.counts
    sites = segformer_attention_sites(c["segformer"], n["batch"], tuple(n["hw"]), "bfloat16")
    return roofline(run, ("segformer_attention",), sites, "bfloat16", "forwards")
