"""The fusion pipeline's model FLOPs (CLIPSeg per (image, prompt) pair, the
UNet per image) per second over the float32 CUDA-core peak."""
from port_bench.metrics.lib import mfu
from port_bench.roofline.flops import clipseg_flops, unet_flops


def read(run):
    c, n = run.cell.config, run.counts
    kw = {k: v for k, v in c["clipseg"].items()}
    kw["extract_layers"] = tuple(kw["extract_layers"])
    per_image = (clipseg_flops(c["clip_size"], **kw) * c["prompts"]
                 + unet_flops(c["unet"]["model"], c["unet"]["base_c"],
                              c["unet"]["num_classes"], tuple(n["bucket"])))
    return mfu(run, per_image, "images", c["dtype"])
