"""Single-model inference CLI (port of ``egm_unet_tpu/cli/predict.py``): per
image, resize the short side to ``--base-size`` and normalize with the
TP-Dataset statistics, a warm-up forward, a timed forward, argmax, the mask
resized back to the original size (bilinear), foreground -> 255, saved as a
PNG named by the last four characters of the image name; prints each
image's latency and the final FPS.

Images are zero-padded to 64-pixel shape buckets, as the JAX CLI pads them,
and the pad region is cut off before the argmax.  Timings end in a device
synchronisation.  The model is the BN-folded graph; ``--weights`` is a
directory written by ``cli/train.py`` (its best epoch, else its latest,
folded) or a file holding the folded graph's ``state_dict``.

    python -m egm_unet_torch.cli.predict --synthetic --amp \\
        --conv-impl pair --upsample-impl fused
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weights", default="save_weights",
                   help="a cli/train.py save directory, or a file holding "
                        "the folded model's state_dict")
    p.add_argument("--data-path", default="./dataset")
    p.add_argument("--txt-name", default="predict.txt")
    p.add_argument("--save-result", default="./predict/test")
    p.add_argument("--model", default="egm_unet")
    p.add_argument("--base-c", default=32, type=int)
    p.add_argument("--num-classes", default=1, type=int)
    p.add_argument("--base-size", default=565, type=int)
    p.add_argument("--amp", action="store_true", help="bf16 compute")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", default=None,
                   help="default: the current CUDA device; 'cpu' runs the "
                        "kernels' plain versions")
    p.add_argument("--conv-impl", default="gemm", choices=["gemm", "pair"],
                   help="'pair': both convs of a DoubleConv in one kernel")
    p.add_argument("--upsample-impl", default="matmul", choices=["matmul", "fused"],
                   help="'fused': the decoder upsample as one kernel")
    return p.parse_args(argv)


def bucket_pad(img: np.ndarray, multiple: int = 64) -> np.ndarray:
    """Zero-pad an HWC image at the bottom and right to the next multiple of
    ``multiple`` pixels, so that a handful of shapes cover every image."""
    h, w = img.shape[:2]
    bh = ((h + multiple - 1) // multiple) * multiple
    bw = ((w + multiple - 1) // multiple) * multiple
    out = np.zeros((bh, bw, img.shape[2]), img.dtype)
    out[:h, :w] = img
    return out


def main(argv=None):
    args = parse_args(argv)

    import torch
    from PIL import Image

    from egm_unet_torch.data import DriveDataset, EvalTransform, SyntheticTPDataset
    from egm_unet_torch.device import resolve_device
    from egm_unet_torch.models import create_model
    from egm_unet_torch.ops.resize import resize_bilinear
    from egm_unet_torch.utils.checkpoint import folded_state_dict, saved_epochs

    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.amp else torch.float32
    model = create_model(args.model, num_classes=args.num_classes + 1,
                         base_c=args.base_c, conv_impl=args.conv_impl,
                         upsample_impl=args.upsample_impl,
                         generator=torch.Generator().manual_seed(0))
    if os.path.isdir(args.weights) and saved_epochs(args.weights):
        model.load_state_dict(folded_state_dict(args.weights, args.model,
                                                args.num_classes + 1, args.base_c))
        print(f"loaded weights from {args.weights}")
    elif os.path.isfile(args.weights):
        model.load_state_dict(torch.load(args.weights, map_location="cpu",
                                         weights_only=True))
        print(f"loaded weights from {args.weights}")
    else:
        print("WARNING: no checkpoint dir found; using random init")
    model = model.to(device, dtype).eval()

    if args.synthetic:
        ds = SyntheticTPDataset(n=4)
    else:
        ds = DriveDataset(args.data_path, None, args.txt_name)
    tf = EvalTransform(args.base_size)

    @torch.inference_mode()
    def forward(x):
        logits = model(x)["out"]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return logits

    os.makedirs(args.save_result, exist_ok=True)

    total_time, count = 0.0, 0
    for i in range(len(ds)):
        raw, _ = ds[i]
        h, w = raw.shape[:2]
        img, _ = tf(raw, None)
        rh, rw = img.shape[:2]
        x = torch.from_numpy(bucket_pad(img)[None]).to(device, dtype)

        forward(x)  # warm-up
        t0 = time.perf_counter()
        logits = forward(x)
        dt = time.perf_counter() - t0
        total_time += dt
        count += 1
        print(f"inference time: {dt}")

        pred = logits[0, :rh, :rw].argmax(dim=-1).float()
        pred_full = resize_bilinear(pred[..., None], (h, w))[..., 0]
        pred = np.rint(pred_full.cpu().numpy()).astype(np.uint8)
        pred[pred == 1] = 255

        name = ds.names[i][-4:]
        Image.fromarray(pred).convert("L").save(
            os.path.join(args.save_result, f"{name}.png"))
    if count:
        print("FPS: {}".format(1 / (total_time / count)))


if __name__ == "__main__":
    main()
