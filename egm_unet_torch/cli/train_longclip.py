"""Long-CLIP contrastive fine-tune CLI (port of
``egm_unet_tpu/cli/train_longclip.py``): the loop over
``engine/longclip_train.py`` (AdamW with ``positional_embedding`` frozen,
the warm-up cosine schedule, the logit-scale clamp) with the JAX CLI's
flags and checkpoints by ``utils/checkpoint.CheckpointManager``.

``--synthetic`` fine-tunes on random (image, long text, short text) triples,
``--synthetic-fixed N`` on a fixed pool of N of them (the pairings can be
learnt, so the loss falls); real use reads ``--data-tsv`` (image path, long
caption, short caption).  Runs on the current CUDA device unless ``--device
cpu`` is given; with no GPU it refuses to start.

Without a checkpoint file the tower is ``--clip-config``'s preset
(``vit_b16`` by default, ``longclip_l14``: Long-CLIP-L, or ``rn50x64``:
OpenAI's RN50x64 stretched to 248 positions) with seeded random weights.
A checkpoint whose widths are a preset's takes that preset's settings
(``models.clip.model.preset_of``): ``--clip-weights RN50x64.pt --stretch``
trains the ``rn50x64`` tower, its blocks recomputed in backward.

``--mesh-data N`` fine-tunes data-parallel on N ranks (default: every
visible GPU; 1 on the CPU), N GPUs under NCCL or, with ``--device cpu``, N
processes under gloo: every rank draws the same global batch of
``--batch-size`` and keeps its rows, the loss gathers the features across
ranks (``engine/longclip_train.py``), and rank 0 alone prints and saves.

    python -m egm_unet_torch.cli.train_longclip --synthetic --synthetic-fixed 64 --steps 10
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from egm_unet_torch.engine.longclip_train import (create_longclip_state,
                                                  make_longclip_train_step)
from egm_unet_torch.models.clip.model import PRESETS
from egm_unet_torch.parallel import launch, replicated, shard_batch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Long-CLIP fine-tune")
    p.add_argument("--clip-weights", default="weights/longclip-B.pt",
                   help="starting checkpoint (or an OpenAI CLIP .pt with "
                        "--stretch to apply the 77->248 positional stretch)")
    p.add_argument("--stretch", action="store_true",
                   help="input is a vanilla 77-ctx CLIP; stretch pos-emb "
                        "to 248 (ref: clip/clip.py:230-251)")
    p.add_argument("--data-tsv", default="",
                   help="TSV: image_path<TAB>long_caption<TAB>short_caption")
    p.add_argument("--steps", default=1000, type=int)
    p.add_argument("-b", "--batch-size", default=32, type=int)
    p.add_argument("--lr", default=1e-6, type=float)
    p.add_argument("--weight-decay", default=1e-2, type=float)
    p.add_argument("--warmup-steps", default=200, type=int)
    p.add_argument("--ratio-short", default=0.1, type=float)
    p.add_argument("--print-freq", default=10, type=int)
    p.add_argument("--save-dir", default="save_weights_longclip")
    p.add_argument("--save-every", default=500, type=int)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-fixed", default=0, type=int,
                   help="synthetic: cycle a FIXED set of N pregenerated "
                        "triples instead of fresh randoms each step — the "
                        "model can memorize the pairings, so the loss curve "
                        "demonstrably decreases")
    p.add_argument("--clip-config", default="vit_b16", choices=tuple(PRESETS),
                   help="the tower to fine-tune from random weights when "
                        "--clip-weights names no file (a checkpoint's shapes win): "
                        "Long-CLIP ViT-B/16, Long-CLIP-L (ViT-L/14) or CLIP RN50x64 "
                        "at 248 positions")
    p.add_argument("--tiny-clip", action="store_true")
    p.add_argument("--mesh-data", default=None, type=int,
                   help="data-parallel ranks (default: every visible GPU; 1 "
                        "on the CPU)")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default=None,
                   help="default: the current CUDA device; 'cpu' runs on the CPU")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Fine-tunes and returns ``{"state", "losses", "save_dir"}``: the final
    train state and every step's loss; with a mesh rank 0's losses and
    ``"state"`` its model's ``state_dict`` on the CPU."""
    args = parse_args(argv)
    cpu = args.device is not None and torch.device(args.device).type == "cpu"
    gpus = 0 if cpu else torch.cuda.device_count()
    world = args.mesh_data or (1 if cpu else max(1, gpus))
    if world == 1:
        return fine_tune(None, args)
    if not cpu and world > gpus:
        raise SystemExit(f"--mesh-data {world}: only {gpus} GPU(s) visible")
    if world < 1 or args.batch_size % world:
        raise SystemExit(f"--batch-size {args.batch_size} must be divisible by "
                         f"--mesh-data {world}")
    return launch(_rank_fine_tune, world, "gloo" if cpu else "nccl", args)[0]


def _rank_fine_tune(group, args) -> dict:
    out = fine_tune(group, args)
    out["state"] = {k: t.detach().cpu() for k, t in out["state"].model.state_dict().items()}
    return out


def fine_tune(group, args) -> dict:
    """The run on one rank of ``group`` (None: one process)."""
    from egm_unet_torch.cli.eval_clipseg import tiny_clip_config
    from egm_unet_torch.device import resolve_device
    from egm_unet_torch.models.clip.model import CLIP, CLIPConfig, preset_of
    from egm_unet_torch.models.registry import init_weights
    from egm_unet_torch.utils.checkpoint import CheckpointManager

    device = resolve_device(args.device)
    main_rank = group is None or group.rank == 0
    say = print if main_rank else (lambda *a, **k: None)
    if group is not None and device.type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // group.world))
    # every rank draws the same global batches and keeps its rows
    rng = np.random.default_rng(args.seed)

    state_dict = None
    if args.tiny_clip:
        cfg = tiny_clip_config(64)
    elif os.path.isfile(args.clip_weights):
        from egm_unet_torch.utils.convert import load_clip_checkpoint

        cfg_kw, state_dict = load_clip_checkpoint(args.clip_weights,
                                                  stretch_to_long=args.stretch)
        cfg = preset_of(CLIPConfig(**cfg_kw))
        say(f"loaded {args.clip_weights} (ctx {cfg.context_length})")
    else:
        cfg = PRESETS[args.clip_config]
        say(f"WARNING: no checkpoint; fine-tuning a random {args.clip_config} tower")

    model = CLIP(cfg)
    if state_dict is None:
        init_weights(model, torch.Generator().manual_seed(args.seed))
    else:
        model.load_state_dict(state_dict)
    model = replicated(model.to(device), group)
    state = create_longclip_state(model, lr=args.lr, weight_decay=args.weight_decay,
                                  warmup_steps=args.warmup_steps,
                                  total_steps=args.steps)
    step_fn = make_longclip_train_step(ratio_short=args.ratio_short, group=group)
    res, ctx, vocab = cfg.image_resolution, cfg.context_length, cfg.vocab_size

    def synthetic_batch():
        img = rng.standard_normal((args.batch_size, res, res, 3)).astype(np.float32)
        tl = rng.integers(1, vocab - 1, (args.batch_size, ctx))
        ts = rng.integers(1, vocab - 1, (args.batch_size, ctx))
        return img, tl.astype(np.int32), ts.astype(np.int32)

    if args.synthetic_fixed:
        n = max(args.synthetic_fixed, args.batch_size)
        pool_img = rng.standard_normal((n, res, res, 3)).astype(np.float32)
        pool_tl = rng.integers(1, vocab - 1, (n, ctx)).astype(np.int32)
        pool_ts = rng.integers(1, vocab - 1, (n, ctx)).astype(np.int32)

        def synthetic_batch():  # noqa: F811 — fixed-set variant
            idx = rng.choice(n, args.batch_size, replace=False)
            return pool_img[idx], pool_tl[idx], pool_ts[idx]

    def tsv_batches():
        from PIL import Image

        from egm_unet_torch.models.clip.tokenizer import tokenize

        with open(args.data_tsv) as f:
            rows = [ln.rstrip("\n").split("\t") for ln in f if ln.strip()]
        while True:
            idxs = rng.permutation(len(rows))
            for s in range(0, len(rows) - args.batch_size + 1, args.batch_size):
                chunk = [rows[i] for i in idxs[s : s + args.batch_size]]
                imgs = [np.asarray(Image.open(path).convert("RGB").resize((res, res)),
                                   np.float32) / 255.0 for path, _, _ in chunk]
                tl = tokenize([c[1] for c in chunk], context_length=ctx, truncate=True)
                ts = tokenize([c[2] for c in chunk], context_length=ctx, truncate=True)
                yield np.stack(imgs), tl, ts

    batches = tsv_batches() if args.data_tsv else None
    ckpt = CheckpointManager(os.path.abspath(args.save_dir), period=args.save_every,
                             writer=main_rank)
    losses = []
    for it in range(args.steps):
        batch = shard_batch(group, *(next(batches) if batches else synthetic_batch()))
        state, aux = step_fn(state, *(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                                      for a in batch))
        losses.append(aux["loss"])
        if it % args.print_freq == 0:
            say(f"step {it}: loss {float(aux['loss']):.4f} lr {aux['lr']:.2e}")
        ckpt.maybe_save(it, args.steps, state)
    ckpt.close()
    say("done")
    return {"state": state, "losses": [float(v) for v in losses],
            "save_dir": ckpt.directory}


if __name__ == "__main__":
    main()
