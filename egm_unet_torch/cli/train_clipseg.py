"""CLIPSeg decoder training CLI on PhraseCut (port of
``egm_unet_tpu/cli/train_clipseg.py``): the reference's configuration
(experiments/phrasecut.yaml: AdamW 1e-3, cosine T_max 20000 eta_min 1e-4,
batch 64, image 352, BCE with logits, the CLIP tower frozen) over
``engine/clipseg_train.py``, with the JAX CLI's flags, data order, prompt
sampling and tokenizer fallback, a per-epoch fgIoU probe and checkpoints
(``utils/checkpoint.CheckpointManager``).  The frozen Long-CLIP tower comes
from ``--longclip-weights`` when that file exists, else from the seed.

Runs on the current CUDA device unless ``--device cpu`` is given; with no
GPU it refuses to start.  ``--synthetic`` trains on a generated
PhraseCut-format directory (``data/phrasecut.make_synthetic_phrasecut``) in
a temporary directory.

    python -m egm_unet_torch.cli.train_clipseg --synthetic --synthetic-n 128 --epochs 3
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from egm_unet_torch.engine.clipseg_train import (clipseg_foreground_iou,
                                                 create_clipseg_state,
                                                 make_clipseg_train_step)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="CLIPSeg PhraseCut training")
    p.add_argument("--data-path", default="./PhraseCut")
    p.add_argument("--longclip-weights", default="weights/longclip-B.pt")
    p.add_argument("--steps", default=20000, type=int,
                   help="cosine T_max (yaml: 20000)")
    p.add_argument("--epochs", default=1, type=int)
    p.add_argument("-b", "--batch-size", default=64, type=int)
    p.add_argument("--lr", default=1e-3, type=float)
    p.add_argument("--eta-min", default=1e-4, type=float)
    p.add_argument("--image-size", default=352, type=int)
    p.add_argument("--reduce-dim", default=64, type=int)
    p.add_argument("--prompt", default="shuffle+")
    p.add_argument("--negative-prob", default=0.2, type=float)
    p.add_argument("--complex-trans-conv", action="store_true")
    p.add_argument("--print-freq", default=10, type=int)
    p.add_argument("--save-dir", default="save_weights_clipseg")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-n", default=0, type=int,
                   help="synthetic: number of generated PhraseCut samples "
                        "(default 2 batches); with --epochs > 1 the loop "
                        "revisits them, so loss/fgIoU curves show learning")
    p.add_argument("--tiny-clip", action="store_true",
                   help="small random CLIP tower (CI smoke)")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default=None,
                   help="default: the current CUDA device; 'cpu' runs on the CPU")
    return p.parse_args(argv)


def hashed_tokens(phrases, context_length: int, vocab_size: int) -> np.ndarray:
    """Token ids without the BPE merges: Python's ``hash`` of each word (as
    the JAX CLI does; stable within one process), EOT the highest id."""
    out = np.zeros((len(phrases), context_length), np.int32)
    for i, ph in enumerate(phrases):
        ids = [(hash(wd) % (vocab_size - 2)) + 1 for wd in ph.split()]
        ids = ids[: context_length - 1]
        out[i, : len(ids)] = ids
        out[i, len(ids)] = vocab_size - 1  # eot
    return out


def main(argv=None) -> dict:
    """Trains and returns ``{"state", "losses", "fgiou", "save_dir"}``: the
    final train state, every step's loss and each epoch's fgIoU probe."""
    args = parse_args(argv)

    from egm_unet_torch.cli.eval_clipseg import tiny_clip_config
    from egm_unet_torch.data.phrasecut import PhraseCutDataset, make_synthetic_phrasecut
    from egm_unet_torch.device import resolve_device
    from egm_unet_torch.models.clip.model import VIT_B16
    from egm_unet_torch.models.clip.tokenizer import tokenize
    from egm_unet_torch.models.clipseg import (CLIPDensePredT, get_prompt_list,
                                               sample_prompts)
    from egm_unet_torch.models.registry import init_weights
    from egm_unet_torch.utils.checkpoint import CheckpointManager
    from egm_unet_torch.utils.convert import load_clip_checkpoint, merge_params

    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    root = args.data_path
    tmp = None
    if args.synthetic:
        tmp = tempfile.TemporaryDirectory(prefix="synthetic_phrasecut_")
        root = tmp.name
        make_synthetic_phrasecut(root, n=args.synthetic_n or max(args.batch_size * 2, 8),
                                 hw=(args.image_size, args.image_size))

    cfg, extract = VIT_B16, (3, 6, 9)
    if args.tiny_clip:
        cfg, extract = tiny_clip_config(args.image_size), (0, 1)
    model = CLIPDensePredT(clip_cfg=cfg, reduce_dim=args.reduce_dim,
                           extract_layers=extract, prompt=args.prompt,
                           complex_trans_conv=args.complex_trans_conv)
    init_weights(model, torch.Generator().manual_seed(args.seed))
    if os.path.isfile(args.longclip_weights):
        _, clip_state = load_clip_checkpoint(args.longclip_weights)
        model.load_state_dict(merge_params(model.state_dict(), clip_state,
                                           prefix="clip."))
        print(f"loaded frozen Long-CLIP tower from {args.longclip_weights}")
    model = model.to(device)
    state = create_clipseg_state(model, lr=args.lr, t_max=args.steps,
                                 eta_min=args.eta_min)

    ds = PhraseCutDataset(root, "train", image_size=args.image_size,
                          negative_prob=args.negative_prob, seed=args.seed)
    prompt_list = ["{}"] if args.prompt == "plain" else get_prompt_list(args.prompt)

    def tokenize_phrases(phrases):
        try:
            return tokenize(phrases, context_length=cfg.context_length, truncate=True)
        except FileNotFoundError:  # the BPE merges are user-supplied data
            return hashed_tokens(phrases, cfg.context_length, cfg.vocab_size)

    step_fn = make_clipseg_train_step()
    ckpt = CheckpointManager(os.path.abspath(args.save_dir), period=1)
    n_batches = max(len(ds) // args.batch_size, 1)
    losses, fgiou = [], []

    for epoch in range(args.epochs):
        order = rng.permutation(len(ds))
        epoch_losses = []
        for bidx in range(n_batches):
            idxs = order[bidx * args.batch_size : (bidx + 1) * args.batch_size]
            samples = [ds[int(i)] for i in idxs]
            images = torch.from_numpy(np.stack([s[0] for s in samples])).to(device)
            segs = torch.from_numpy(np.stack([s[1] for s in samples])).to(device)
            phrases = sample_prompts([s[2] for s in samples], prompt_list, rng)
            tokens = torch.from_numpy(tokenize_phrases(phrases)).to(device)
            state, aux = step_fn(state, images, segs, tokens)
            epoch_losses.append(aux["loss"])
            if bidx % args.print_freq == 0:
                print(f"epoch {epoch} [{bidx}/{n_batches}] "
                      f"loss {float(aux['loss']):.4f} lr {aux['lr']:.6f}")
        losses += [float(v) for v in epoch_losses]
        # a quick train-set fgIoU probe on the epoch's last batch (the yaml's
        # pc_fgiou metric family)
        with torch.no_grad():
            (logits,) = model(images, tokens)
        fgiou.append(float(clipseg_foreground_iou(logits[..., 0], segs)))
        print(f"epoch {epoch}: fgIoU {fgiou[-1]:.3f}")
        ckpt.maybe_save(epoch, args.epochs, state, extra={"args": vars(args)})
    ckpt.close()
    if tmp is not None:
        tmp.cleanup()
    return {"state": state, "losses": losses, "fgiou": fgiou,
            "save_dir": ckpt.directory}


if __name__ == "__main__":
    main()
