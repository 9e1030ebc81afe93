"""Fusion eval + alpha search CLI (port of ``egm_unet_tpu/cli/eval_clipseg.py``).

Pipeline per validation image:
1. GRFB/EGM-UNet logits at Resize(565) + TP statistics;
2. CLIPSeg logits at 352x352 + CLIP statistics, batched over the prompts
   (``['background', 'Tactile paving']``), bilinearly resized to the UNet
   grid;
3. alpha grid search (linspace 0.1..10, 100 points) on the global validation
   mIoU -> ``best_alpha.txt``;
4. masks re-rendered with the best alpha (0 -> 0, 1 -> 255).

Runs in float32 on the current CUDA device unless ``--device cpu`` is given.  The two
branches and the fused prediction are functions (``resize_frames``,
``run_branches``, ``fused_masks``) that ``predict_clipseg`` shares.  The host
does only the PIL resizes and sends each resized frame to the device once,
as uint8; the normalisation, the repeat over the prompts and the bucket and
chunk padding run there, bit for bit the host's float32 pipeline
(``preprocess``).

Their stages are spans and counters of ``utils/profiling.py`` (recorded only
under a profiler or ``profiling.recording()``): ``fusion`` (one
``fused_masks`` call) over ``fusion.preprocess``, ``fusion.clip.pack``,
``fusion.clip.forward``, ``fusion.unet.pack``, ``fusion.unet.forward``,
``fusion.fuse`` and, inside it, ``fusion.readback`` (one per mask); counters
``fusion.images`` and ``fusion.h2d_bytes`` (every host array sent to the
device).  ``--trace-dir DIR`` runs the preprocessing and the branch passes
under ``profiling.trace(DIR)`` (``DIR/trace.json``, ``DIR/spans.json``) and
prints the stage table per image.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import List, Sequence

import numpy as np
import torch

from egm_unet_torch.data import DriveDataset, SyntheticTPDataset
from egm_unet_torch.data.transforms import (IMAGENET_MEAN, IMAGENET_STD, TP_MEAN,
                                            TP_STD, EvalTransform, device_normalize,
                                            normalize)
from egm_unet_torch.device import resolve_device
from egm_unet_torch.engine.fusion import fuse_logits, save_alpha, search_best_alpha
from egm_unet_torch.models import create_model
from egm_unet_torch.models.clip.model import VIT_B16, CLIPConfig
from egm_unet_torch.models.clip.tokenizer import tokenize
from egm_unet_torch.models.clipseg import CLIPDensePredT
from egm_unet_torch.models.registry import init_weights
from egm_unet_torch.ops.resize import resize_bilinear, resize_nearest
from egm_unet_torch.serving import bucket_batches, unet_state, zero_padding
from egm_unet_torch.utils import profiling
from egm_unet_torch.utils.convert import (clipseg_decoder_from_torch,
                                          load_clip_checkpoint, merge_params)

def add_common_args(p: argparse.ArgumentParser) -> None:
    """The flags the two fusion CLIs share."""
    p.add_argument("--data-path", default="./dataset")
    p.add_argument("--unet-weights", default="save_weights",
                   help="a cli/train.py save directory, or a file holding the "
                        "folded model's state_dict; absent = seeded random weights")
    p.add_argument("--clipseg-weights", default="weights/rd64-uni.pth")
    p.add_argument("--longclip-weights", default="weights/longclip-B.pt")
    p.add_argument("--model", default="grfb_unet")
    p.add_argument("--base-c", default=32, type=int)
    p.add_argument("--clip-size", default=352, type=int)
    p.add_argument("--base-size", default=565, type=int)
    p.add_argument("--alpha-file", default="best_alpha.txt")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--clip-batch", default=32, type=int,
                   help="fixed CLIPSeg device batch")
    p.add_argument("--unet-batch", default=16, type=int,
                   help="fixed UNet device batch per shape bucket")
    p.add_argument("--tiny-clip", action="store_true",
                   help="small random CLIP tower (smoke runs; no checkpoints)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; fails without a GPU) or 'cpu'")
    p.add_argument("--trace-dir", default=None,
                   help="profile the fusion into DIR (trace.json, spans.json) "
                        "and print its stage table per image")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    add_common_args(p)
    p.add_argument("--txt-name", default="val.txt")
    p.add_argument("--prompts", nargs="+", default=["background", "Tactile paving"])
    p.add_argument("--save-result", default="./predict/fusion_eval")
    p.add_argument("--timed-passes", default=1, type=int,
                   help="run the two-branch device compute N times and time "
                        "each pass; results come from the last pass")
    return p.parse_args(argv)


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``; its bytes counted as ``fusion.h2d_bytes``."""
    profiling.count("fusion.h2d_bytes", a.nbytes)
    return torch.from_numpy(a).to(device)


def stage_table(tab: dict, n_images: int) -> str:
    """``profiling.table()`` per image: each span's milliseconds and self
    milliseconds and its calls, each counter's value."""
    lines = [f"# stage table per image ({n_images} images): ms, self ms, calls"]
    for name in sorted(tab):
        rec = tab[name]
        if "seconds" in rec:
            lines.append(f"{name:<22} {rec['seconds'] / n_images * 1e3:10.3f} "
                         f"{rec['self_seconds'] / n_images * 1e3:10.3f} {rec['count']:6d}")
        else:
            lines.append(f"{name:<22} {rec['value'] / n_images:21.1f}")
    return "\n".join(lines)


def run_in_chunks(forward, inputs: Sequence[torch.Tensor], batch_size: int) -> torch.Tensor:
    """Run [N, ...] tensors through ``forward`` in fixed-size chunks; the
    last chunk is padded with zero rows on the tensors' device and the
    outputs of its padding rows dropped."""
    n = inputs[0].shape[0]
    outs = []
    for s in range(0, n, batch_size):
        chunk = [a[s:s + batch_size] for a in inputs]
        pad = batch_size - chunk[0].shape[0]
        if pad:
            chunk = [torch.cat([c, c.new_zeros((pad,) + c.shape[1:])]) for c in chunk]
        out = forward(*chunk)
        outs.append(out[: batch_size - pad] if pad else out)
    return torch.cat(outs, dim=0)


def tiny_clip_config(clip_size: int) -> CLIPConfig:
    return CLIPConfig(embed_dim=32, image_resolution=clip_size, vision_layers=2,
                      vision_width=64, vision_patch_size=16, context_length=32,
                      vocab_size=512, transformer_width=64, transformer_heads=2,
                      transformer_layers=2, long_clip=True)


def build_clipseg(args, device) -> CLIPDensePredT:
    """CLIPDensePredT(ViT-B/16, reduce_dim=64) with the Long-CLIP tower and
    the rd64-uni decoder where the checkpoint files exist; seeded random
    weights otherwise."""
    tiny = getattr(args, "tiny_clip", False)
    cfg = tiny_clip_config(args.clip_size) if tiny else VIT_B16
    clip_state = None
    if os.path.isfile(args.longclip_weights):
        cfg_kw, clip_state = load_clip_checkpoint(args.longclip_weights)
        cfg = CLIPConfig(**cfg_kw)
        print(f"loaded Long-CLIP tower from {args.longclip_weights}")
    model = CLIPDensePredT(clip_cfg=cfg, reduce_dim=64,
                           extract_layers=(0, 1) if tiny else (3, 6, 9))
    init_weights(model, torch.Generator().manual_seed(0))
    state = model.state_dict()
    if clip_state is not None:
        state = merge_params(state, clip_state, prefix="clip.")
    if os.path.isfile(args.clipseg_weights):
        sd = torch.load(args.clipseg_weights, map_location="cpu", weights_only=False)
        state = merge_params(state, clipseg_decoder_from_torch(sd))
        print(f"loaded CLIPSeg decoder from {args.clipseg_weights} (non-strict)")
    else:
        print("WARNING: no rd64 checkpoint; CLIPSeg decoder randomly initialized")
    model.load_state_dict(state)
    return model.to(device).eval()


def build_unet(args, device) -> torch.nn.Module:
    """The folded UNet on ``--unet-weights`` (``serving.unet_state``); seeded
    random weights where it holds none."""
    unet = create_model(args.model, num_classes=2, base_c=args.base_c,
                        generator=torch.Generator().manual_seed(0))
    state = unet_state(args.unet_weights, args.model, 2, args.base_c)
    if state is not None:
        unet.load_state_dict(state)
        print(f"loaded UNet weights from {args.unet_weights}")
    return unet.to(device).eval()


@torch.no_grad()
def prompt_conditionals(clipseg: CLIPDensePredT, prompts, device,
                        tiny: bool = False) -> torch.Tensor:
    """[P, embed_dim] float32 text embeddings of the prompts; random ones
    (seed 1) when the BPE vocabulary is missing or the tower is the tiny
    random one, whose tokens mean nothing."""
    if not tiny:
        try:
            tokens = torch.from_numpy(tokenize(prompts, truncate=True)).to(device)
            return clipseg.compute_conditional(tokens).float()
        except FileNotFoundError:
            print("WARNING: BPE vocab missing; using random prompt embeddings")
    return torch.randn((len(prompts), clipseg.clip_cfg.embed_dim),
                       generator=torch.Generator().manual_seed(1)).to(device)


def resize_frames(raws: Sequence[np.ndarray], base_size: int, clip_size: int):
    """The host half of both branches' preprocessing, PIL only:
    ``(img565s, img352s)``, uint8 HWC, the short-side resize to
    ``base_size`` and the square BILINEAR resize to ``clip_size``."""
    from PIL import Image

    tf = EvalTransform(base_size, wire_uint8=True)
    img565s, img352s = [], []
    with profiling.span("fusion.preprocess"):
        for raw in raws:
            img565s.append(tf(raw, None)[0])
            img352s.append(np.asarray(Image.fromarray(raw).resize(
                (clip_size, clip_size), Image.BILINEAR)))
    return img565s, img352s


def preprocess(raws: Sequence[np.ndarray], base_size: int, clip_size: int):
    """Both branches' preprocessing on the host in float32, the reference's:
    ``resize_frames``, then ``normalize`` with TP statistics and with
    ImageNet statistics.  ``run_branches`` computes the same numbers on the
    device from ``resize_frames``."""
    img565s, img352s = resize_frames(raws, base_size, clip_size)
    return ([normalize(im) for im in img565s],
            [normalize(im, IMAGENET_MEAN, IMAGENET_STD) for im in img352s])


@torch.no_grad()
def run_branches(clipseg, unet, cond: torch.Tensor, img565s, img352s, *,
                 clip_batch: int, unet_batch: int, device, info=None):
    """Both branches on the device, from ``resize_frames``'s uint8 frames.
    Returns ``(cl, ul)``: ``cl`` float32 [N, S, S, P] CLIPSeg logits, one
    channel per prompt; ``ul`` a list of float32 [h, w, C] UNet logits at
    each image's resized shape.  ``info`` (a dict) receives the numbers of
    forwards run."""
    n = len(img565s)
    n_prompts = cond.shape[0]
    size = img352s[0].shape[0]
    unet_dtype = next(unet.parameters()).dtype
    forwards = {"clipseg_forwards": 0, "unet_forwards": 0}

    def clipseg_forward(x, c):
        forwards["clipseg_forwards"] += 1
        return clipseg(x, c)[0]

    # CLIPSeg: each frame sent once, normalised and repeated image-major over
    # the prompts on the device, ceil(N * P / clip_batch) forwards
    with profiling.span("fusion.clip.pack"):
        x = device_normalize(to_device(np.stack(img352s), device),
                             IMAGENET_MEAN, IMAGENET_STD)
        rows = x.repeat_interleave(n_prompts, dim=0)
        conds = cond.to(device, torch.float32).repeat(n, 1)
    with profiling.span("fusion.clip.forward"):
        cl_flat = run_in_chunks(clipseg_forward, (rows, conds), clip_batch)
    cl = cl_flat[..., 0].reshape(n, n_prompts, size, size).permute(0, 2, 3, 1)

    # UNet: 64-px shape buckets x fixed uint8 batches, normalised on the
    # device with zeros outside the images and in the free slots
    ul: List[torch.Tensor] = [None] * n  # type: ignore[list-item]
    for idxs, batch in bucket_batches(img565s, unet_batch,
                                      lambda: profiling.span("fusion.unet.pack")):
        with profiling.span("fusion.unet.forward"):
            x = device_normalize(to_device(batch, device), TP_MEAN, TP_STD, unet_dtype)
            x = zero_padding(x, [img565s[i].shape[:2] for i in idxs])
            out = unet(x)["out"]
        forwards["unet_forwards"] += 1
        for row, i in enumerate(idxs):
            h, w = img565s[i].shape[:2]
            ul[i] = out[row, :h, :w]
    if info is not None:
        info.update(forwards)
        info["logits_finite"] = bool(torch.isfinite(cl).all()) and all(
            bool(torch.isfinite(u).all()) for u in ul)
    return cl, ul


@torch.no_grad()
def fused_masks(clipseg, unet, cond: torch.Tensor, raws: Sequence[np.ndarray],
                alpha: float, *, base_size: int = 565, clip_size: int = 352,
                clip_batch: int = 32, unet_batch: int = 16, device="cuda",
                info=None) -> List[np.ndarray]:
    """The fusion prediction for raw uint8 HWC images: PIL resizes ->
    CLIPSeg in chunks of ``clip_batch`` -> UNet by 64-px bucket in chunks of
    ``unet_batch`` -> CLIPSeg logits bilinearly resized to the UNet grid ->
    ``clip + alpha * unet`` -> argmax -> nearest (PIL convention) resize to
    the raw size.  Returns uint8 masks with values 0 and 255."""
    with profiling.span("fusion"):
        profiling.count("fusion.images", len(raws))
        img565s, img352s = resize_frames(raws, base_size, clip_size)
        cl_all, ul = run_branches(clipseg, unet, cond, img565s, img352s,
                                  clip_batch=clip_batch, unet_batch=unet_batch,
                                  device=device, info=info)
        masks = []
        with profiling.span("fusion.fuse"):
            for i, raw in enumerate(raws):
                rh, rw = img565s[i].shape[:2]
                cl = resize_bilinear(cl_all[i][None], (rh, rw))
                pred = fuse_logits(cl, ul[i][None], alpha).argmax(dim=-1)
                pred = resize_nearest(pred[0], raw.shape[:2], mode="pil")
                mask = (pred * 255).to(torch.uint8)
                with profiling.span("fusion.readback"):
                    masks.append(mask.cpu().numpy())
    return masks


def main(argv=None):
    args = parse_args(argv)
    from PIL import Image

    device = resolve_device(args.device)
    unet = build_unet(args, device)
    clipseg = build_clipseg(args, device)
    cond = prompt_conditionals(clipseg, args.prompts, device, args.tiny_clip)

    ds = (SyntheticTPDataset(8) if args.synthetic
          else DriveDataset(args.data_path, None, args.txt_name))
    n = len(ds)
    raws, targets = [], []
    for i in range(n):
        raw, target = ds[i]
        raws.append(raw)
        targets.append(target.astype(np.int32))
    with (profiling.trace(args.trace_dir) if args.trace_dir else contextlib.nullcontext()):
        img565s, img352s = resize_frames(raws, args.base_size, args.clip_size)

        for pnum in range(max(1, args.timed_passes)):
            t0 = time.perf_counter()
            cl_all, ul_list = run_branches(
                clipseg, unet, cond, img565s, img352s, clip_batch=args.clip_batch,
                unet_batch=args.unet_batch, device=device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            print(f"# branch pass {pnum + 1}: {n / max(dt, 1e-9):.2f} img/s "
                  f"({dt:.2f}s for {n} images x {len(args.prompts)} prompts)", flush=True)
    if args.trace_dir:
        print(stage_table(profiling.table(), n))

    # per (resized shape, label shape) group: CLIPSeg logits bilinearly to
    # the UNet grid, then both branches NEAREST to the label size (a gather,
    # so it commutes with the fusion and the argmax), one confusion-matrix
    # batch per group for the alpha sweep
    groups = {}
    for i in range(n):
        groups.setdefault((img565s[i].shape[:2], targets[i].shape[:2]), []).append(i)
    pairs, group_order = [], []
    with torch.no_grad():
        for ((rh, rw), (lh, lw)), idxs in groups.items():
            cl = resize_bilinear(cl_all[idxs], (rh, rw))
            cl = resize_nearest(cl, (lh, lw), mode="pil")
            ul = resize_nearest(torch.stack([ul_list[i] for i in idxs]), (lh, lw),
                                mode="pil")
            labels = torch.from_numpy(np.stack([targets[i] for i in idxs])).to(device)
            pairs.append((cl, ul, labels))
            group_order.append(idxs)

        best_alpha, best_miou, _ = search_best_alpha(pairs)
    print(f"best alpha: {best_alpha:.4f}  val mIoU: {best_miou * 100:.2f}")
    save_alpha(best_alpha, args.alpha_file)

    os.makedirs(args.save_result, exist_ok=True)
    for (cl, ul, _), idxs in zip(pairs, group_order):
        preds = fuse_logits(cl, ul, best_alpha).argmax(dim=-1).cpu().numpy()
        for row, i in enumerate(idxs):
            Image.fromarray((preds[row] * 255).astype(np.uint8)).save(
                os.path.join(args.save_result, f"{ds.names[i]}.png"))
    print(f"wrote {n} masks to {args.save_result}")


if __name__ == "__main__":
    main()
