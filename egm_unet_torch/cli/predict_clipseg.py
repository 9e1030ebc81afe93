"""Fusion predict CLI (port of ``egm_unet_tpu/cli/predict_clipseg.py``): the
same two-branch pipeline as ``eval_clipseg``, but alpha is loaded from
``best_alpha.txt`` (0.5 when absent) and the masks are rendered for
``predict.txt`` at the original image size (NEAREST), values {0, 255}.

The default prompt pair holds a long descriptive tactile-paving prompt, the
payload of Long-CLIP's 248-token context.  Runs on the current CUDA device
unless ``--device cpu`` is given.

``--trace-dir DIR`` runs ``fused_masks`` under ``profiling.trace(DIR)``
(``DIR/trace.json``, the profiler's timeline with the fusion's stage spans;
``DIR/spans.json``, the span table) and prints the stage table per image
(``eval_clipseg``'s docstring names the spans)."""

from __future__ import annotations

import argparse
import contextlib
import os

from egm_unet_torch.cli.eval_clipseg import (add_common_args, build_clipseg,
                                             build_unet, fused_masks,
                                             prompt_conditionals, stage_table)
from egm_unet_torch.data import DriveDataset, SyntheticTPDataset
from egm_unet_torch.device import resolve_device
from egm_unet_torch.engine.fusion import load_alpha
from egm_unet_torch.utils import profiling

DEFAULT_PROMPTS = [
    "background",
    "Tactile paving: a strip of textured gu"
    "ide bricks on the sidewalk, usually bright yellow with raised parallel "
    "bars or round dots, laid in a continuous path to gu"
    "ide visually impaired pedestrians; it contrasts with the surrounding "
    "pavement in both color and texture and often runs along the center of "
    "the walkway or bends at intersections.",
]


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    add_common_args(p)
    p.add_argument("--txt-name", default="predict.txt")
    p.add_argument("--prompts", nargs="+", default=DEFAULT_PROMPTS)
    p.add_argument("--save-result", default="./predict/fusion")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from PIL import Image

    device = resolve_device(args.device)
    alpha = load_alpha(args.alpha_file)
    print(f"alpha = {alpha} (from {args.alpha_file})")

    unet = build_unet(args, device)
    clipseg = build_clipseg(args, device)
    cond = prompt_conditionals(clipseg, args.prompts, device, args.tiny_clip)

    ds = (SyntheticTPDataset(4) if args.synthetic
          else DriveDataset(args.data_path, None, args.txt_name))
    os.makedirs(args.save_result, exist_ok=True)
    raws = [ds[i][0] for i in range(len(ds))]
    with (profiling.trace(args.trace_dir) if args.trace_dir else contextlib.nullcontext()):
        masks = fused_masks(clipseg, unet, cond, raws, alpha, base_size=args.base_size,
                            clip_size=args.clip_size, clip_batch=args.clip_batch,
                            unet_batch=args.unet_batch, device=device)
    if args.trace_dir:
        print(stage_table(profiling.table(), len(raws)))
    for name, mask in zip(ds.names, masks):
        Image.fromarray(mask).convert("L").save(
            os.path.join(args.save_result, f"{name}.png"))
    print(f"wrote {len(masks)} masks to {args.save_result}")


if __name__ == "__main__":
    main()
