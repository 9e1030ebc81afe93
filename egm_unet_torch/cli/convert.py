"""Checkpoint conversion CLI (port of ``egm_unet_tpu/cli/convert.py``, the
same flags): a reference torch checkpoint -> what the port's CLIs read.

- ``--kind egm``: a reference EGM-UNet ``.pth`` (train.py's ``{'model':
  state_dict, ...}`` or a bare state dict) -> a ``utils/checkpoint.py``
  directory holding it as epoch 0, with its BatchNorm statistics (the JAX
  CLI saves ``maybe_save(0, 1, state)`` the same way, as orbax).
  ``serving.Predictor.from_checkpoint``, ``cli/serve.py --weights``,
  ``cli/predict.py --weights`` (all folding the BatchNorms) and
  ``cli/train.py --resume`` read it.
- ``--kind clip``: a CLIP / Long-CLIP checkpoint (``longclip-B.pt`` or an
  OpenAI ``ViT-B/16``; ``--stretch-long`` gives a 77-token one the Long-CLIP
  positional stretch) -> one ``torch.save``d file ``{"config": the scalar
  CLIPConfig fields, "params": the CLIP state_dict}``, which
  ``utils.convert.load_converted_clip`` reads back.

    python -m egm_unet_torch.cli.convert --kind egm --torch model_best.pth \\
        --out save_weights --model egm_unet --base-c 32
    python -m egm_unet_torch.cli.convert --kind clip --torch longclip-B.pt \\
        --out weights_torch/longclip.pt
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--kind", choices=["egm", "clip"], default="egm")
    p.add_argument("--torch", required=True, help="torch checkpoint path")
    p.add_argument("--out", required=True,
                   help="output: a checkpoint directory (egm) or a file (clip)")
    p.add_argument("--model", default="egm_unet")
    p.add_argument("--base-c", default=32, type=int)
    p.add_argument("--num-classes", default=2, type=int)
    p.add_argument("--stretch-long", action="store_true",
                   help="apply the Long-CLIP 77->248 positional stretch")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import torch

    if args.kind == "egm":
        from egm_unet_torch.engine import create_train_state, warmup_poly_schedule
        from egm_unet_torch.models import create_model
        from egm_unet_torch.utils.checkpoint import CheckpointManager
        from egm_unet_torch.utils.convert_unet import load_egm_checkpoint, variant_of
        from egm_unet_torch.utils.from_flax import load_flax_variables

        params, stats = load_egm_checkpoint(args.torch, **variant_of(args.model))
        model = load_flax_variables(
            create_model(args.model, num_classes=args.num_classes, base_c=args.base_c,
                         fold_bn=False),
            {"params": params, "batch_stats": stats})
        state = create_train_state(model, warmup_poly_schedule(0.02, 1, 1))
        mngr = CheckpointManager(os.path.abspath(args.out))
        mngr.maybe_save(0, 1, state)
        mngr.close()
        print(f"wrote checkpoint to {args.out}")
    else:
        from egm_unet_torch.utils.convert import load_clip_checkpoint

        cfg_kw, params = load_clip_checkpoint(args.torch,
                                              stretch_to_long=args.stretch_long)
        out = os.path.abspath(args.out)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        torch.save({"config": {k: v for k, v in cfg_kw.items()
                               if isinstance(v, (int, float, bool))},
                    "params": params}, out)
        print(f"wrote CLIP params to {args.out} (config: {cfg_kw})")


if __name__ == "__main__":
    main()
