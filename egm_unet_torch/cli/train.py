"""Training CLI (port of ``egm_unet_tpu/cli/train.py``), with the reference's
contract: the same flags, epoch loop and printout (per-epoch confusion
matrix and ``dice coefficient:``), the results-txt blocks, the checkpoint
cadence and ``--resume``.  It trains the BatchNorm graph
(``create_model(..., fold_bn=False)``), which launches no hand-written
kernel, on one CUDA device unless ``--device cpu`` is given; with no GPU it
refuses to start rather than fall back to the CPU.

Extra flags over the reference: --model (registry name), --base-c,
--synthetic* (train without the TP-Dataset), --device, and the JAX
package's --device-aug (the host copies fixed-size source canvases, the
device augments them: ``data/device_aug.py``) and --device-cache (every
canvas on the device once, one index vector copied per step:
``data/device_cache.py``; it implies --device-aug).  Both draw each epoch's
augmentation from a generator seeded by (seed, epoch), so --resume replays
an uninterrupted run's draws on the cache path; both refuse
--steps-per-dispatch > 1.

--mesh-data N trains data-parallel (``parallel/``) on N ranks: N GPUs under
NCCL (rank r on GPU r), or N processes on the CPU under gloo with --device
cpu.  Its default is every visible GPU, and 1 on the CPU or with
--device-cache, which is single-device and exits with a mesh, as in the JAX
CLI.  --batch-size is the global batch; each rank loads and steps on its
rows of it (by microbatch with --grad-accum), the BatchNorms and the loss
reduce over the global batch, the eval set is split by batches and its
metrics summed, and rank 0 alone prints, writes the results file and saves
checkpoints.

--mesh-spatial S also splits each training image's rows over S ranks
(spatial parallelism, ``parallel/halo.py``): --mesh-data x S ranks in a grid
(``parallel.make_grid``), the S ranks of a data rank loading the same rows
of the batch (one crop and flip stream per data rank) and each stepping on
its image rows (``shard_batch_spatial``'s split), the BatchNorms, the loss
and the gradients reduced over every rank.  --mesh-data then defaults to
the visible GPUs / S (1 on the CPU).  Validation images are not split: the
eval batches go round all the ranks whole, and checkpoints are written as
under --mesh-data, as in the JAX CLI.  The crop's fifth stage must leave
every spatial rank a row (480 px over up to 30 ranks).

    python -m egm_unet_torch.cli.train --synthetic --amp --epochs 2
    python -m egm_unet_torch.cli.train --synthetic --device cpu --mesh-data 2 \
        --base-c 8 --batch-size 4 --epochs 1
    python -m egm_unet_torch.cli.train --synthetic --device cpu --mesh-spatial 2 \
        --base-c 8 --batch-size 2 --epochs 1
"""

from __future__ import annotations

import argparse
import gc
import os
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="egm_unet_torch training")
    p.add_argument("--data-path", default="./dataset", help="TP-Dataset root")
    p.add_argument("--num-classes", default=1, type=int,
                   help="foreground classes (background added internally)")
    p.add_argument("--model", default="egm_unet")
    p.add_argument("--base-c", default=32, type=int)
    p.add_argument("-b", "--batch-size", default=8, type=int)
    p.add_argument("--epochs", default=200, type=int)
    p.add_argument("--lr", default=0.02, type=float)
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--weight-decay", default=1e-4, type=float)
    p.add_argument("--print-freq", default=10, type=int)
    p.add_argument("--resume", default="", help="checkpoint dir to resume from")
    p.add_argument("--start-epoch", default=0, type=int)
    p.add_argument("--save-best", default=True, type=bool)
    p.add_argument("--amp", action="store_true",
                   help="bf16 compute on float32 parameters")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-size", default=64, type=int)
    p.add_argument("--synthetic-n", default=None, type=int,
                   help="synthetic train-set size (default 4*batch; 876 "
                        "mirrors the TP-928 train split)")
    p.add_argument("--synthetic-val-n", default=8, type=int,
                   help="synthetic val-set size (TP-928 val split: 52)")
    p.add_argument("--no-aux-losses", action="store_true",
                   help="train with plain CE only (drops the dice + laplace "
                        "+ lap + sobel terms of the reference recipe)")
    p.add_argument("--synthetic-hard", action="store_true",
                   help="the distractor-laden synthetic generator")
    p.add_argument("--val-batch-size", default=1, type=int,
                   help="eval batch (the reference uses 1)")
    p.add_argument("--device-aug", action="store_true",
                   help="copy fixed-size source canvases; scale, crop, flip "
                        "and normalize on the device")
    p.add_argument("--device-cache", action="store_true",
                   help="keep the train set's canvases on the device and copy "
                        "one index vector per step (implies --device-aug)")
    p.add_argument("--eval-size", default=565, type=int)
    p.add_argument("--mesh-data", default=None, type=int,
                   help="data-parallel ranks (default: every visible GPU / "
                        "--mesh-spatial; 1 on the CPU or with --device-cache)")
    p.add_argument("--mesh-spatial", default=1, type=int,
                   help="spatial ranks per data rank: each training image's "
                        "rows split over them")
    p.add_argument("--save-dir", default="save_weights")
    p.add_argument("--save-every", default=100, type=int,
                   help="periodic checkpoint cadence in epochs (best-dice "
                        "saves are additional)")
    p.add_argument("--results-file", default=None)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--wire-uint8", action="store_true",
                   help="copy raw uint8 crops and normalize on the device")
    p.add_argument("--steps-per-dispatch", default=1, type=int,
                   help="K train steps per step call "
                        "(engine.make_train_multistep)")
    p.add_argument("--grad-accum", default=1, type=int,
                   help="split each batch into N sequential microbatches, "
                        "one optimizer update (engine.make_train_step_accum)")
    p.add_argument("--remat", action="store_true",
                   help="checkpoint each stage in backward (large batches)")
    p.add_argument("--remat-fine", action="store_true",
                   help="also checkpoint each conv and GRFB branch inside "
                        "the stages (implies --remat)")
    p.add_argument("--device", default=None,
                   help="default: the current CUDA device; 'cpu' runs on "
                        "the CPU")
    return p.parse_args(argv)


def refuse_unported(args) -> None:
    """Exit non-zero for --steps-per-dispatch > 1 with the device-side
    augmentation (the multi-step stacks host batches)."""
    if (args.device_aug or args.device_cache) and args.steps_per_dispatch > 1:
        raise SystemExit("--steps-per-dispatch > 1 needs host-side transforms; "
                         "drop --device-aug / --device-cache")


def on_cpu(args) -> bool:
    import torch

    return args.device is not None and torch.device(args.device).type == "cpu"


def data_world(args) -> int:
    """The number of data-parallel ranks (--mesh-data, see the module
    docstring); exits where the run cannot have them (with --mesh-spatial,
    --mesh-data x --mesh-spatial ranks)."""
    import torch

    from egm_unet_torch.parallel import check_spatial_height

    cpu = on_cpu(args)
    gpus = 0 if cpu else torch.cuda.device_count()
    spatial = args.mesh_spatial
    if spatial < 1:
        raise SystemExit(f"--mesh-spatial {spatial}: at least 1")
    world = args.mesh_data
    if world is None:
        world = 1 if cpu or args.device_cache else max(1, gpus // spatial)
    if world < 1:
        raise SystemExit(f"--mesh-data {world}: at least 1")
    if world * spatial > 1:
        if args.device_cache:
            raise SystemExit("--device-cache is single-device; drop --mesh-data "
                             "and --mesh-spatial")
        if not cpu and world * spatial > gpus:
            raise SystemExit(f"--mesh-data {world} x --mesh-spatial {spatial}: only "
                             f"{gpus} GPU(s) visible")
        step = world * max(1, args.grad_accum)
        if args.batch_size % step:
            raise SystemExit(f"--batch-size {args.batch_size} must be divisible by "
                             f"--mesh-data x --grad-accum = {step}")
    if spatial > 1:
        try:
            check_spatial_height(args.synthetic_size if args.synthetic else 480, spatial)
        except ValueError as e:
            raise SystemExit(f"--mesh-spatial {spatial}: {e}")
    return world


def main(argv=None):
    """Trains; returns ``{"epoch_losses", "best_dice"}`` (rank 0's with a
    mesh)."""
    args = parse_args(argv)
    refuse_unported(args)
    world = data_world(args)
    spatial = args.mesh_spatial
    if world * spatial == 1:
        return train(None, args)
    from egm_unet_torch.parallel import launch

    return launch(train, world * spatial, "gloo" if on_cpu(args) else "nccl", args,
                  grid=(world, spatial) if spatial > 1 else None)[0]


def train(group, args) -> dict:
    """The run on one rank of ``group`` (None: one process; a ``Grid`` with
    --mesh-spatial)."""
    import torch

    from egm_unet_torch import metrics as M
    from egm_unet_torch.data import (DriveDataset, EvalTransform, SyntheticTPDataset,
                                     TrainTransform, collate_pad)
    from egm_unet_torch.data.loader import (BatchLoader, DevicePrefetcher,
                                            SuperBatcher, narrow_for_transfer,
                                            to_device)
    from egm_unet_torch.data.device_aug import augment_with_params, draw_params, to_unit
    from egm_unet_torch.data.device_cache import (DeviceDatasetCache, RawSource,
                                                  epoch_generator, scale_range,
                                                  source_size)
    from egm_unet_torch.data.transforms import TP_MEAN, TP_STD
    from egm_unet_torch.device import resolve_device
    from egm_unet_torch.engine import (create_train_state, make_eval_step,
                                       make_train_multistep, make_train_step,
                                       make_train_step_accum, reduce_eval,
                                       warmup_poly_schedule)
    from egm_unet_torch.models import create_model
    from egm_unet_torch.parallel import Grid, rank_rows, replicated, row_range
    from egm_unet_torch.utils.checkpoint import CheckpointManager
    from egm_unet_torch.utils.logging import MetricLogger, ResultsWriter

    device = resolve_device(args.device)
    grid = group if isinstance(group, Grid) else None
    if grid is not None:
        group = grid.world
    rank, world = (0, 1) if group is None else (group.rank, group.world)
    # this rank's data rank (the spatial ranks of one load the same rows)
    d_rank, n_data = (grid.data_rank, grid.n_data) if grid else (rank, world)
    main_rank = rank == 0
    say = print if main_rank else (lambda *a, **k: None)
    if world > 1 and device.type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    num_classes = args.num_classes + 1
    dtype = torch.bfloat16 if args.amp else torch.float32

    crop = args.synthetic_size if args.synthetic else 480
    device_aug = args.device_aug or args.device_cache
    if device_aug:
        src = source_size(crop)
        min_size, max_size = scale_range(src)
        train_tf = RawSource(src)
    else:
        # each rank its own stream of random crops and flips
        train_tf = TrainTransform(crop_size=crop,
                                  seed=args.seed if group is None else [args.seed, d_rank],
                                  wire_uint8=args.wire_uint8)
    val_tf = EvalTransform(args.eval_size, wire_uint8=args.wire_uint8)
    if args.synthetic:
        # the cache reads each raw sample once: no host copy of them to keep
        train_ds = SyntheticTPDataset(n=args.synthetic_n or args.batch_size * 4,
                                      transforms=train_tf,
                                      cache=not args.device_cache,
                                      hard=args.synthetic_hard)
        # the val split takes another seed offset than the train split
        val_ds = SyntheticTPDataset(n=args.synthetic_val_n, transforms=val_tf,
                                    cache=True, hard=args.synthetic_hard,
                                    seed0=500_000)
    else:
        train_ds = DriveDataset(args.data_path, train_tf, "train.txt")
        val_ds = DriveDataset(args.data_path, val_tf, "val.txt")

    accum = max(1, args.grad_accum)
    if accum > 1 and args.batch_size % accum:
        raise SystemExit(f"--batch-size {args.batch_size} must be divisible "
                         f"by --grad-accum {accum}")
    # this rank's rows of every global batch, by microbatch
    rows = None if group is None else rank_rows(args.batch_size, d_rank, n_data, accum)
    train_loader = BatchLoader(train_ds, args.batch_size, shuffle=True, seed=args.seed,
                               rows=rows)
    val_loader = BatchLoader(val_ds, args.val_batch_size, shuffle=False,
                             drop_last=False, collate=collate_pad, shard=(rank, world))

    model = create_model(args.model, num_classes=num_classes, base_c=args.base_c,
                         fold_bn=False,
                         remat="fine" if args.remat_fine else args.remat,
                         generator=torch.Generator().manual_seed(args.seed))
    model = model.to(device)
    sched = warmup_poly_schedule(args.lr, len(train_loader), args.epochs)
    state = create_train_state(model, sched, momentum=args.momentum,
                               weight_decay=args.weight_decay)

    ckpt = CheckpointManager(os.path.abspath(args.save_dir), period=args.save_every,
                             writer=main_rank)
    start_epoch = args.start_epoch
    if args.resume:  # every rank restores
        restored = CheckpointManager(os.path.abspath(args.resume),
                                     writer=False).restore(state)
        start_epoch = restored["epoch"] + 1
        say(f"resumed from epoch {restored['epoch']}")
    replicated(state.model, group)

    k_steps = max(1, args.steps_per_dispatch)
    # the device augmentation normalizes; --wire-uint8 leaves it to the step
    norm = (TP_MEAN, TP_STD) if args.wire_uint8 and not device_aug else None
    step_kw = dict(num_classes=num_classes, dice=not args.no_aux_losses,
                   normalize=norm, input_dtype=dtype, group=group,
                   spatial=grid.inner if grid else None)
    if k_steps > 1:
        train_step = make_train_multistep(accum=accum, **step_kw)
    elif accum > 1:
        train_step = make_train_step_accum(accum, **step_kw)
    else:
        train_step = make_train_step(**step_kw)
    eval_step = make_eval_step(num_classes=num_classes, normalize=norm,
                               input_dtype=dtype)
    results = ResultsWriter(args.results_file, writer=main_rank)

    cache = None
    if args.device_cache:
        cache = DeviceDatasetCache(train_ds, src, TP_MEAN, TP_STD, crop, min_size,
                                   max_size, out_dtype=dtype, device=device)
        say(f"device cache: {cache.n} samples, {cache.hbm_bytes / 1e6:.0f} MB "
            f"on {device}")

    # with --mesh-spatial: this rank's rows of each image (the H axis is the
    # one before W, C in images and before W in targets)
    h_rows = (slice(*row_range(crop, grid.inner_rank, grid.n_inner)) if grid
              else slice(None))

    def split_rows(images, targets):
        return images[..., h_rows, :, :], targets[..., h_rows, :]

    # the next batch is narrowed (bf16 images, uint8 masks) and copied from
    # pinned memory in a worker thread while the current step runs
    def prepare(batch):
        return to_device(narrow_for_transfer(batch[0], batch[1], dtype), device)

    def prepare_train(batch):
        images, targets = batch
        if not device_aug:
            images, targets = split_rows(images, targets)
        return prepare((images, targets))

    rows_dev = None if rows is None else torch.as_tensor(rows, device=device)

    def train_batches(epoch):
        """The epoch's device batches: from the cache, or the loader's
        (augmented on the device with --device-aug)."""
        if cache is not None:
            yield from cache.epoch_iter(epoch_generator(args.seed, epoch, device),
                                        args.batch_size,
                                        np.random.default_rng(args.seed + epoch))
            return
        source = train_loader if k_steps == 1 else SuperBatcher(train_loader, k_steps)
        gen = epoch_generator(args.seed, epoch, device) if device_aug else None
        for images, targets in DevicePrefetcher(source, prepare_train):
            if gen is not None:
                # the global batch's draws on every rank, this rank's rows
                params = draw_params(gen, args.batch_size, src, crop, min_size,
                                     max_size, rows=rows_dev)
                images, targets = split_rows(*augment_with_params(
                    to_unit(images), targets, params, TP_MEAN, TP_STD, crop))
                images = images.to(dtype)
            yield images, targets

    best_dice = -1.0
    epoch_losses = []
    t_start = time.time()
    for epoch in range(start_epoch, args.epochs):
        logger = MetricLogger(writer=main_rank)
        # losses stay on the device and are read once per print window, so
        # that the host does not wait on every step
        pending = []

        def flush_pending():
            if not pending:
                return
            losses = torch.cat([torch.atleast_1d(a["loss"]).float().cpu()
                                for a in pending]).numpy()
            lrs = np.concatenate([np.atleast_1d(np.asarray(a["lr"], np.float64))
                                  for a in pending])
            for lo, lr_ in zip(losses, lrs):
                logger.update(loss=float(lo), lr=float(lr_))
            pending.clear()

        window = max(1, args.print_freq // k_steps)
        step_i = 0
        for images, targets in logger.log_every(
                train_batches(epoch), window, f"Epoch: [{epoch}]"):
            state, aux = train_step(state, images, targets)
            pending.append(aux)
            if step_i % window == 0:  # the logger prints after this body
                flush_pending()
            step_i += 1
        flush_pending()
        mean_loss = logger.meters["loss"].global_avg
        lr = logger.meters["lr"].value
        epoch_losses.append(mean_loss)

        confmat = M.confmat_init(num_classes, device=device)
        dice = M.dice_init(device=device)
        for images, targets in DevicePrefetcher(val_loader, prepare):
            confmat, dice = eval_step(state, images, targets, confmat, dice)
        confmat, dice = reduce_eval(confmat, dice, group)
        block = M.confmat_str(confmat.cpu())
        dice_val = float(dice.value)
        say(block)
        say(f"dice coefficient: {dice_val:.3f}")
        results.write_epoch(epoch, mean_loss, lr, block, dice_val)

        ckpt.maybe_save(epoch, args.epochs, state,
                        dice=dice_val if args.save_best else None,
                        extra={"args": vars(args)})
        best_dice = max(best_dice, dice_val)
        gc.collect()

    total = time.time() - t_start
    say(f"training time {total / 3600:.2f}h; best dice {best_dice:.3f}")
    train_loader.close()
    val_loader.close()
    ckpt.close()
    return {"epoch_losses": epoch_losses, "best_dice": best_dice}


if __name__ == "__main__":
    main()
