"""Single-model inference CLI (port of ``egm_unet_tpu/cli/predict.py``): per
image, resize the short side to ``--base-size`` and normalize with the
TP-Dataset statistics, a warm-up forward, a timed forward, argmax, the mask
resized back to the original size (bilinear), foreground -> 255, saved as a
PNG named by the last four characters of the image name; prints each
image's latency and the final FPS.

A loop over a ``serving.Predictor`` at batch size 1: each image is
zero-padded to its 64-pixel shape bucket, as the JAX CLI pads it, the timed
``Predictor.forward`` ends in a device synchronisation, and the mask is
cropped and resized back as ``Predictor.predict`` does.  The model is the
BN-folded graph; ``--weights`` is what ``serving.unet_state`` reads: a
directory written by ``cli/train.py`` (its best epoch, else its latest,
folded) or a file holding the folded graph's ``state_dict``.

    python -m egm_unet_torch.cli.predict --synthetic --amp \\
        --conv-impl pair --upsample-impl fused
"""

from __future__ import annotations

import argparse
import os
import time


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


def main(argv=None):
    args = parse_args(argv)

    import torch
    from PIL import Image

    from egm_unet_torch.data import DriveDataset, SyntheticTPDataset
    from egm_unet_torch.serving import (Predictor, PredictorConfig, bucket_batches,
                                        restore_mask, unet_state)

    cfg = PredictorConfig(model_name=args.model, base_c=args.base_c,
                          num_classes=args.num_classes + 1, batch_size=1,
                          base_size=args.base_size,
                          dtype="bfloat16" if args.amp else "float32",
                          conv_impl=args.conv_impl, upsample_impl=args.upsample_impl)
    pred = Predictor(config=cfg, device=args.device)
    state = unet_state(args.weights, cfg.model_name, cfg.num_classes, cfg.base_c)
    if state is None:
        print("WARNING: no checkpoint dir found; using random init")
    else:
        pred.model.load_state_dict(state)
        print(f"loaded weights from {args.weights}")
    device = pred.device

    if args.synthetic:
        ds = SyntheticTPDataset(n=4)
    else:
        ds = DriveDataset(args.data_path, None, args.txt_name)

    def forward(x):
        masks = pred.forward(x)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return masks

    os.makedirs(args.save_result, exist_ok=True)

    total_time, count = 0.0, 0
    for i in range(len(ds)):
        raw, _ = ds[i]
        img = pred.preprocess(raw)
        [(_, batch)] = bucket_batches([img], 1)
        x = torch.from_numpy(batch).to(device, pred.dtype)

        forward(x)  # warm-up
        t0 = time.perf_counter()
        masks = forward(x)
        dt = time.perf_counter() - t0
        total_time += dt
        count += 1
        print(f"inference time: {dt}")

        pred_mask = restore_mask(masks[0], img.shape, raw.shape[:2])
        pred_mask[pred_mask == 1] = 255

        name = ds.names[i][-4:]
        Image.fromarray(pred_mask).convert("L").save(
            os.path.join(args.save_result, f"{name}.png"))
    if count:
        print("FPS: {}".format(1 / (total_time / count)))


if __name__ == "__main__":
    main()
