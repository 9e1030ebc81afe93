#!/usr/bin/env python3
"""GPU smoke run of egm_unet_torch: builds the CUDA kernels from
``egm_unet_torch/csrc``, holds each against its plain PyTorch version at the
shapes the main paths give it, and drives the main paths at full width:

- serving: a few requests through ``serving.Predictor`` (EGM-UNet A+B+C,
  base_c 32, 2 classes, bf16, batch 8) on the default kernel route
  (``conv3x3_gemm`` + ``up_concat_conv``);
- fusion: 16 images and two text prompts through the text-prompted pipeline
  of ``cli/predict_clipseg.py`` (CLIPSeg rd64 over ViT-B/16 at 352 px with the
  248-token Long-CLIP text tower, batch 32, plus EGM-UNet at 565 px, batch 16,
  both bf16, fused as ``clip + 0.5 * unet``); the fusion's uint8 wire
  (``fusion_wire``: the CLIPSeg rows and UNet batches that ``run_branches``
  normalises, repeats and pads on the card, bit for bit the host's float32
  ``preprocess``, ``np.repeat`` and ``bucket_batches``, every byte value
  in both branches); then the float32 CLIPSeg
  forward at batch 32 that ``cli/eval_clipseg.py`` and
  ``cli/predict_clipseg.py`` run (``clipseg_f32``: ms per batch, img/s, K6's
  10 launches, a profile with K6's share);
- serve: the HTTP server of ``cli/serve.py`` on 127.0.0.1 with the same
  EGM-UNet on the pair / fused-upsample route (``conv3x3_pair_gemm`` +
  ``upsample2x_fused``), answering 12 concurrent PNG requests of two sizes;
- predict_cli: ``cli/predict.py --synthetic --amp`` on that route;
- train (with autograd on, after the serving phases, which run under
  ``torch.inference_mode()``): egm_unet's BatchNorm graph at batch 8 on
  480x480 crops, SGD 0.02, in bf16, float32 and bf16 with stage remat,
  which must launch no hand-written kernel; ``cli/train.py`` for two epochs,
  resumed for a third, its checkpoint served folded on the kernels;
- train_device_cache: TP-928's scale (876 synthetic 565x752 images) held on
  the card as 960x960 uint8 canvases (``data/device_cache.py``, about 3.2
  GB), one epoch of egm_unet training in bf16 at batch 8 on 480 crops
  augmented on the card (109 steps, one index vector copied per step),
  beside 30 steps of the host loader; before it, one batch augmented with the
  same draws on the card and on the CPU (``device_aug_card_vs_cpu``);
- quant: the serving bucket in bf16 and under int8df, int8 and int8full
  (``ops/quant.py``, calibrated on the batch), on random weights and on the
  trained checkpoint: ms per batch, launches, masks against bf16 (int8df
  must agree on >= 99% of the trained checkpoint's pixels); then
  ``cli/serve.py --quant int8df`` answering a burst of 4 PNG requests
  (``serve_quant``).

- the text branch's training, float32 with TF32 off as the JAX CLIs run it:
  ``cli/train_clipseg.py`` at the reference's configuration (CLIPSeg rd64
  over a frozen ViT-B/16 Long-CLIP tower, batch 64 at 352 px, 128 synthetic
  PhraseCut samples, 3 epochs: 6 steps; K6 10 times a step and a probe),
  ``cli/train_longclip.py`` on a random ViT-B/16 Long-CLIP (batch 32, a
  fixed pool of 64 synthetic triples, 10 steps; K6 once a step, forward,
  with its closed-form backward), each with one more step under the
  profiler; K6 in float32 at both shapes and the backward's time
  (``text_kernel_records``); and an RN50-width CLIP's ``encode_image`` at
  batch 32 (``clip_resnet``, no hand-written kernel).

- convert_tail, after the serving phases: seeded reference checkpoints in
  the reference's key layout (``egm_unet`` and the yuan ``egm_unet_ab``,
  base_c 32; a ViT-B/16 CLIP with 77 text positions) converted by three
  ``cli/convert.py`` processes started together (``--kind egm``, ``--kind
  clip --stretch-long``); each UNet directory served by
  ``Predictor.from_checkpoint`` at the bucket, batch 8, bf16, on both kernel
  routes with each route's launch counts, the egm_unet one in float32 on the
  card against the CPU, ``cli/predict.py`` on it scored by
  ``cli/evaluating_indicator.py`` on the card (confusion matrix equal to one
  counted here), one forward under ``utils/profiling.py``'s ``span`` and
  ``trace`` (``convert_serve``); the CLIP file read back into the fusion
  phase's CLIPSeg, its logits bit-equal to the direct load (``convert_clip``);
  ``VITDensePredT`` at ViT-B/16 384 (``vitseg``), the ``nn/extra.py``
  modules (``extra_modules``) card against CPU; the native BPE loop against
  the Python one (``native_bpe``).

- data parallel (``egm_unet_torch/parallel``), last: the train step and
  ``cli/train_longclip.py``'s step under an NCCL group of one (the card's
  one GPU) at the ``train`` and ``train_longclip`` configurations, bit for
  bit against the one-process steps, with ms per step, collectives per step
  and a profiled step (``dp_train``, ``dp_longclip``); and two ranks that
  share the card over gloo (``dp_two_ranks_card``): egm_unet base_c 8 in
  float32 one step and one --grad-accum 2 step held against one process on
  the whole batch at ``dryrun_multichip``'s bounds, the full-width bf16 step
  timed, and a tiny Long-CLIP's loss and gradient norm across the two ranks
  held against one process with the PCA proxy per rank block.

It then checks the card against the CPU on small inputs, for the UNets on
every route and for a small CLIPSeg, for one training step, for one step of
each text trainer and K6's backward (``text_train_card_vs_cpu``) and for a
small RN CLIP; and that K1..K5 and K7..K9 refuse to run inside an autograd
graph.

K7 ``mca_gates`` (the MCALayer's three gate vectors, which replaces no TPU
kernel) is held to 2e-6 absolute on the gates and 1e-5 relative on each
mean and standard deviation (relative to the mean of |x| for the mean),
against its plain version on the same card, at the serving sites and, in
``gates``, at the four sites' shapes at batch 32, batch 1, ragged H and W,
C = 32 and both variants in both dtypes; every call launched twice must give
the same gates bit for bit, and so must an image alone and in a batch.

K8 ``eafe_edge`` (the EdgeAwareFeatureEnhancer's ``x - avg3x3(x)``, which
replaces no TPU kernel) must equal its plain version, the composite ``x -
avg_pool2d(x, 3, 1, 1)``, bit for bit on the same card: at the serving sites
and, in ``eafe``, at the eight path shapes at batch 8 and 32 in both dtypes
(two launches the same bits, an image alone and in a batch the same bits),
and at small and odd shapes on both variants; timed at batch 32 beside the
plain composite and the library's ``avg_pool2d`` and subtraction.

K9 ``conv1x1_gemm`` (the folded graph's bf16 1x1 convs with the bias and
the ReLU in the epilogue, which replaces no TPU kernel) runs at every site
of the bf16 forward (``conv1x1``: 57 a forward on every folded route and
under int8df, none in float32, under int8, int8full or calibration): on
exact operands (integers and multiples of 1/64, whose float32 sums are exact
in any order) it must give its plain version's bits at batch 8 and 32, on
seeded ReLU'd maps one bf16 rounding step of the output's magnitude; timed at
batch 32 beside the route it replaced (cuDNN's conv, PyTorch's bias add and
``F.relu``) and its bytes bound.

``conv3x3_gemm``, ``conv3x3_pair_gemm``, ``up_concat_conv`` and
``csa_attention`` have two hand-written kernels each, chosen by dtype:
bfloat16 multiplies on the tensor cores (``mma_bf16``), float32 on the CUDA
cores (``cuda_cores_f32``; ``ffma_f32`` for ``csa_attention``, whose records
carry its tiles ``csa_f32_tiles`` as ``tile``).
``mca_fused`` and ``upsample2x_fused`` have a kernel that stages 16-byte
tiles (``tile_tma`` by the TMA unit, ``band_cp_async`` by cp.async) and a
scalar one for shapes and pointers off the 16-byte grid.  Every ``kernel`` record carries the wrapper's choice as
``variant`` (and the three convolutions' their ``tile`` and executed FLOPs),
and the run fails if a path record names another kernel than its dtype's
tensor-core or CUDA-core one, or, for K1 and K4, than the 16-byte one.
Kernel records time one call twice: ``kernel_ms`` with the wrapper's host
work and ``device_ms`` with it hidden behind a device-side sleep.  ``csa_attention``'s path record is taken as the
transformer blocks give it, on the three ``chunk`` views of one fused
``in_proj`` output (``layout: in_proj_views``); a record on contiguous tensors
stands beside it.

    python3 chip_smoke.py

Needs one CUDA GPU and ``nvcc``; exits non-zero, printing no result, without
them.  Each phase prints one JSON line; the last three lines are the card's
``nvidia-smi`` name and power limit, the per-kernel summary, and
``{"ok": true, "device": {...}}``.  Every printed record also goes to
``chiprun_out/chip_smoke_records.jsonl``, the per-shape kernel records to
``chiprun_out/chip_smoke_kernels.jsonl``.

float32 checks run with TF32 off (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32`` False), so the plain versions on
the card compute in full float32.
"""

from __future__ import annotations

import contextlib
import dataclasses
import http.client
import io
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from PIL import Image

from egm_unet_torch import native
from egm_unet_torch.cli import evaluating_indicator
from egm_unet_torch.cli import predict as predict_cli
from egm_unet_torch.cli import serve as serve_cli
from egm_unet_torch.cli import train as train_cli
from egm_unet_torch.cli import train_clipseg as train_clipseg_cli
from egm_unet_torch.cli import train_longclip as train_longclip_cli
from egm_unet_torch.cli.eval_clipseg import tiny_clip_config
from egm_unet_torch.cli.eval_clipseg import fused_masks, preprocess, resize_frames, run_branches
from egm_unet_torch.data.device_aug import (augment_with_params, draw_params,
                                            source_coords, to_unit)
from egm_unet_torch.data.device_cache import (DeviceDatasetCache, epoch_generator,
                                              scale_range, source_canvas, source_size)
from egm_unet_torch.data.loader import (BatchLoader, DevicePrefetcher,
                                        narrow_for_transfer, to_device)
from egm_unet_torch.data.synthetic import SyntheticTPDataset, synthetic_tp_sample
from egm_unet_torch.data.transforms import (IMAGENET_MEAN, IMAGENET_STD, TP_MEAN, TP_STD,
                                            TrainTransform, device_normalize, normalize,
                                            resize_short_side)
from egm_unet_torch.engine import (create_train_state, make_train_step, make_train_step_accum,
                                   warmup_poly_schedule)
from egm_unet_torch.engine.clipseg_train import create_clipseg_state, make_clipseg_train_step
from egm_unet_torch.engine.longclip_train import (MAX_LOGIT_SCALE, create_longclip_state,
                                                  cross_entropy_smoothed,
                                                  make_longclip_loss_fn,
                                                  make_longclip_train_step, pca_reconstruct)
from egm_unet_torch.models import create_model
from egm_unet_torch.models.clip.model import CLIP, VIT_B16, CLIPConfig
from egm_unet_torch.models.clip.tokenizer import SimpleTokenizer, tokenize
from egm_unet_torch.models.clipseg import CLIPDensePredT
from egm_unet_torch.models.registry import init_weights
from egm_unet_torch.models.vitseg import VITDensePredT
from egm_unet_torch.nn import extra, grfb, layers
from egm_unet_torch.nn.attention import MCALayer, mca_kernel_size
from egm_unet_torch.nn.layers import (BasicConv, ConvBNReLU, DoubleConv,
                                      EdgeAwareFeatureEnhancer, cast_weights, takes_conv1x1)
from egm_unet_torch.ops.cuda import (build, conv1x1, conv3x3, csa, edge, gates,
                                     launch_counts, mca, reset_launch_counts, resize2x,
                                     upconv)
from egm_unet_torch.ops.quant import QUANT_MODES, SHIP_QSTORE_SITES
from egm_unet_torch.parallel import (all_reduce_grads, gather_clip_state, launch,
                                     shard_batch, shard_batch_spatial, shard_clip,
                                     use_data_group, use_spatial_group)
from egm_unet_torch.serving import Predictor, PredictorConfig, bucket_batches, bucket_of
from egm_unet_torch.utils.checkpoint import (best_epoch, folded_state_dict, load_payload,
                                             saved_epochs)
from egm_unet_torch.utils.convert import load_clip_checkpoint, load_converted_clip
from egm_unet_torch.utils.profiling import (device_synchronized, recording, reset_table, span,
                                             table, trace)

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
BUCKET = (576, 768)  # the 565x752 requests' bucket
BATCH = 8
BASE_C = 32
SEED = 0
SOURCES = {"mca_fused": "egm_unet_torch/csrc/mca_fused.cu",
           "mca_gates": "egm_unet_torch/csrc/mca_gates.cu",
           "eafe_edge": "egm_unet_torch/csrc/eafe_edge.cu",
           "conv1x1_gemm": "egm_unet_torch/csrc/conv1x1.cu",
           "conv3x3_gemm": "egm_unet_torch/csrc/conv3x3.cu",
           "conv3x3_pair_gemm": "egm_unet_torch/csrc/conv3x3_pair.cu",
           "upsample2x_fused": "egm_unet_torch/csrc/upsample2x.cu",
           "up_concat_conv": "egm_unet_torch/csrc/up_concat_conv.cu",
           "csa_attention": "egm_unet_torch/csrc/csa_attention.cu"}
REPLACES = {"mca_fused": "egm_unet_tpu/ops/pallas/mca.py:133",
            "mca_gates": "none; the JAX package computes the gates in plain jnp",
            "eafe_edge": "none; the JAX package computes the EAFE's edge in plain jnp",
            "conv1x1_gemm": "none; the JAX package leaves its 1x1 convolutions to XLA",
            "conv3x3_gemm": "egm_unet_tpu/ops/pallas/conv3x3.py:306",
            "conv3x3_pair_gemm": "egm_unet_tpu/ops/pallas/conv3x3.py:234",
            "upsample2x_fused": "egm_unet_tpu/ops/pallas/resize2x.py:191",
            "up_concat_conv": "egm_unet_tpu/ops/pallas/upconv.py:136",
            "csa_attention": "egm_unet_tpu/ops/pallas/csa.py:125"}


def per_forward(**launches) -> dict:
    """Launch counts by kernel name, 0 for the kernels not named."""
    return {name: launches.get(name, 0) for name in SOURCES}


# kernel launches of one EGM-UNet forward on the default route, of one on the
# pair / fused-upsample route (the stem and the four decoder DoubleConvs are
# one pair launch each, which takes the stem's two and the decoders' four
# second convs from conv3x3_gemm), and of one CLIPSeg forward; every folded
# route computes each MCALayer's gates with one mca_gates call and the edge of
# each EGRFB's two EdgeAwareFeatureEnhancers with one eafe_edge call each; in
# bf16 the plain 1x1 convs take conv1x1_gemm: ten an EGRFB, the channel
# attention's fc_down and fc_up twice in stages 2-4 (stage 1's 16 -> 4 is off
# the 8-grid) and five of the RGA's (its gate*_up have N = 1)
PER_FORWARD = per_forward(mca_fused=4, mca_gates=4, eafe_edge=8, conv3x3_gemm=18,
                          up_concat_conv=4, conv1x1_gemm=57)
PER_FORWARD_PAIR = per_forward(mca_fused=4, mca_gates=4, eafe_edge=8, conv3x3_gemm=12,
                               conv3x3_pair_gemm=5, upsample2x_fused=4, conv1x1_gemm=57)
PER_CLIPSEG_FORWARD = per_forward(csa_attention=10)  # blocks 0..9; 10, 11 not needed
# int8 serving on the default route with the shipping storage sites: int8df
# keeps K2, K5 and K9 and gives up K1 (its xout site is active); int8 runs
# every conv as int8_conv and keeps K1; int8full neither; all three keep K7
# and K8 (the EAFE's edge is computed in the working dtype between storage
# sites)
PER_FORWARD_QUANT = {"int8df": per_forward(mca_gates=4, eafe_edge=8, conv3x3_gemm=18,
                                           up_concat_conv=4, conv1x1_gemm=57),
                     "int8": per_forward(mca_fused=4, mca_gates=4, eafe_edge=8),
                     "int8full": per_forward(mca_gates=4, eafe_edge=8)}
# int8 calibration: one full-precision forward whose MCALayers take the
# unfused route after their gates, its convs on conv2d
PER_CALIBRATION = per_forward(mca_gates=4, eafe_edge=8)


def in_float32(launches: dict) -> dict:
    """A bf16 forward's ``launches`` as the same forward makes them in
    float32, whose 1x1 convs keep cuDNN (conv1x1_gemm computes in bf16)."""
    return {**launches, "conv1x1_gemm": 0}


# the fusion path, the defaults of cli/predict_clipseg.py
CLIP_SIZE, CLIP_BATCH, UNET_BATCH, BASE_SIZE, ALPHA = 352, 32, 16, 565, 0.5
N_FUSION_IMAGES = 16
CSA_PATH_SHAPE = (CLIP_BATCH, (CLIP_SIZE // 16) ** 2 + 1, 768, 12)  # B, S, D, heads
SOT, EOT = 49406, 49407
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16
# tensor-core and float32 CUDA-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
SLEEP_CYCLES = 400_000  # about 0.2 ms at the H100's clocks: longer than a wrapper's host work


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    with open(OUT_DIR / "chip_smoke_records.jsonl", "a") as f:
        f.write(line + "\n")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Median CUDA-event time of one call."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def aligned16(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


# the kernel each path record must name: by dtype for the four tensor-core
# kernels, the 16-byte kernel in both dtypes for K1 and K4
PATH_VARIANTS = {"mca_fused": {"bfloat16": "tile_tma", "float32": "tile_tma"},
                 "upsample2x_fused": {"bfloat16": "band_cp_async",
                                      "float32": "band_cp_async"}}
for _name in ("conv3x3_gemm", "conv3x3_pair_gemm", "up_concat_conv"):
    PATH_VARIANTS[_name] = {"bfloat16": "mma_bf16", "float32": "cuda_cores_f32"}
PATH_VARIANTS["csa_attention"] = {"bfloat16": "mma_bf16", "float32": "ffma_f32"}
PATH_VARIANTS["mca_gates"] = {"bfloat16": "vec16", "float32": "vec16"}
PATH_VARIANTS["eafe_edge"] = {"bfloat16": "vec16", "float32": "vec16"}
PATH_VARIANTS["conv1x1_gemm"] = {"bfloat16": "mma_bf16"}
GATE_TOL = 2e-6  # K7's gates, absolute (float32 sums in another order)
GATE_STAT_TOL = 1e-5  # K7's means and standard deviations, relative


def device_time_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Median CUDA-event time of one call with the host's work hidden: a
    device-side sleep queued before the start event outlasts the wrapper's
    host work, so the events bracket only the device's.  ``time_ms`` counts
    both, as a caller with an idle card sees them."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(nb: int, flops: float, dtype) -> tuple:
    t_bytes = nb / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------- phases

def phase_device() -> dict:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    dev = {"name": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(),
           "nvidia_smi": smi.stdout.strip().splitlines()[0],
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "tf32": False}
    emit({"phase": "device", **dev})
    return dev


def phase_build() -> None:
    t0 = time.perf_counter()
    info = build.build_all()
    regs = {name: [ln.strip() for ln in i["ptxas"].splitlines() if "registers" in ln]
            for name, i in info.items()}
    for name, i in info.items():
        (OUT_DIR / f"ptxas_{name}.txt").write_text(i["ptxas"])
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "per_kernel_s": {n: round(i["seconds"], 3) for n, i in info.items()},
          "ptxas_registers": regs})


def make_predictor():
    cfg = PredictorConfig(model_name="egm_unet", base_c=BASE_C, num_classes=2,
                          batch_size=BATCH, dtype="bfloat16")
    return Predictor(config=cfg, device="cuda",
                     generator=torch.Generator().manual_seed(SEED))


def make_pair_server():
    """The HTTP server of ``cli/serve.py`` as a user starts it with
    ``--init-random`` (seed 0, the weights of ``make_predictor``) on the pair /
    fused-upsample route, bound to a free port of 127.0.0.1; not serving yet."""
    args = serve_cli.parse_args([
        "--init-random", "--model", "egm_unet", "--base-c", str(BASE_C),
        "--num-classes", "1", "--batch-size", str(BATCH), "--dtype", "bfloat16",
        "--conv-impl", "pair", "--upsample-impl", "fused",
        "--batch-window-ms", "50", "--host", "127.0.0.1", "--port", "0"])
    return serve_cli.make_server(args)


def bucket_batch(pred, images) -> torch.Tensor:
    """The predictor's own preprocessing, packed into one bucket batch."""
    batch = np.zeros((BATCH, *BUCKET, 3), np.float32)
    for row, img in enumerate(images):
        p = pred.preprocess(img)
        check(p.shape[0] <= BUCKET[0] and p.shape[1] <= BUCKET[1],
              f"image {p.shape} does not fit bucket {BUCKET}")
        batch[row, :p.shape[0], :p.shape[1]] = p
    return torch.from_numpy(batch).to("cuda", pred.dtype)


def capture_sites(model, x, kinds=(ConvBNReLU, BasicConv, MCALayer,
                                   EdgeAwareFeatureEnhancer)):
    """Run one forward and record every call of a module of ``kinds`` with
    its inputs."""
    sites, hooks = [], []
    for name, mod in model.named_modules():
        if isinstance(mod, kinds):
            if isinstance(mod, BasicConv) and not mod.Conv_0.is_plain3x3():
                continue

            def hook(m, args, kwargs, name=name):
                sites.append((name, m, args, kwargs))
            hooks.append(mod.register_forward_pre_hook(hook, with_kwargs=True))
    with torch.inference_mode():
        model(x)
    for h in hooks:
        h.remove()
    return sites


def pair_site_calls(mod, args, kwargs, cast) -> list:
    """The kernel calls of a DoubleConv on the pair / fused-upsample route:
    ``upsample2x_fused`` on the decoder's low-resolution input where there is
    one, then ``conv3x3_pair_gemm`` on the (concatenated) input."""
    calls = []
    up_pair = kwargs.get("up_pair")
    if up_pair is not None:
        x2, x1 = cast(up_pair[0].contiguous()), cast(up_pair[1].contiguous())
        up = resize2x.upsample2x_fused(x1)
        x1_nchw = x1.permute(0, 3, 1, 2)

        def up_library():  # one PyTorch call of the same function, timed only
            return F.interpolate(x1_nchw, scale_factor=2, mode="bilinear",
                                 align_corners=True)
        # per output element: two 2-tap blends along W, one along H
        calls.append(("upsample2x_fused", ("up2x", tuple(x1.shape), str(x1.dtype)),
                      lambda: resize2x.upsample2x_fused(x1),
                      lambda: resize2x.upsample2x_plain(x1), up_library,
                      nbytes(x1, up), 9.0 * up.numel(), x1.dtype,
                      {"variant": resize2x.upsample_variant(x1.dtype, x1.shape[-1],
                                                            aligned16(x1))}))
        x = torch.cat([x2, up], dim=-1)
    else:
        x = cast(args[0].contiguous())
    c1, c2 = mod.ConvBNReLU_0.Conv_0, mod.ConvBNReLU_1.Conv_0
    w1, w2 = cast(c1.kernel), cast(c2.kernel)
    b1, b2 = c1.bias.float(), c2.bias.float()
    cm, co = w1.shape[-1], w2.shape[-1]
    out_numel = x.numel() // x.shape[-1] * co
    needed, executed = conv3x3.pair_flops(tuple(x.shape), cm, co, x.element_size())
    x_nchw = x.permute(0, 3, 1, 2)
    w1_oihw, w2_oihw = (w.permute(3, 2, 0, 1).contiguous() for w in (w1, w2))
    b1_lib, b2_lib = b1.to(x.dtype), b2.to(x.dtype)

    def library():  # cuDNN's two convs with bias and ReLU, timed only
        mid = F.relu(F.conv2d(x_nchw, w1_oihw, b1_lib, padding=1))
        return F.relu(F.conv2d(mid, w2_oihw, b2_lib, padding=1))
    calls.append(("conv3x3_pair_gemm",
                  ("pair", tuple(x.shape), cm, co, str(x.dtype)),
                  lambda: conv3x3.conv3x3_pair_gemm(x, w1, b1, w2, b2),
                  lambda: conv3x3.conv3x3_pair_plain(x, w1, b1, w2, b2), library,
                  nbytes(x, w1, w2, b1, b2) + out_numel * x.element_size(), needed,
                  x.dtype, {"executed_flops": executed,
                            "tile": list(conv3x3.pair_tile(x.shape[-1], cm, co, x.element_size())),
                            "variant": conv3x3.pair_variant(x.dtype)}))
    return calls


def site_calls(site, dtype=None) -> list:
    """The kernel calls of one captured site, its tensors cast to ``dtype``
    when given; each is (kernel name, shape key, kernel fn, plain fn, library
    fn or None, bytes, flops, dtype[, extra record fields])."""
    name, mod, args, kwargs = site
    cast = (lambda t: t) if dtype is None else (lambda t: t.to(dtype).contiguous())
    if isinstance(mod, DoubleConv):
        return pair_site_calls(mod, args, kwargs, cast)
    if isinstance(mod, MCALayer):
        return [site_call(site, cast), gate_call(cast(args[0].contiguous()), layer_params(mod))]
    if isinstance(mod, EdgeAwareFeatureEnhancer):
        return [edge_call(cast(args[0].contiguous()))]
    return [site_call(site, cast)]


def layer_params(mod) -> list:
    """The (weight, conv) pairs of an MCALayer's H, W and C gates."""
    return [(g.weight, g.conv) for g in (mod.h_cw, mod.w_hc, mod.c_hw)]


def gate_checks(x, params) -> dict:
    """K7 against its plain version on the same card: the gates (absolute),
    each axis's mean and standard deviation (relative; the mean's relative
    to the mean of |x| over the same axes, which bounds a float32 sum's
    error), and two launches' gates bit for bit.  Fails the run past a
    tolerance; returns the worst errors over their tolerances."""
    got, stats = gates.mca_gates(x, params, stats=True)
    again = gates.mca_gates(x, params)
    torch.cuda.synchronize()
    ref = gates.mca_gates_plain(x, params)
    gate_err = max((a - b).abs().max().item() for a, b in zip(got, ref))
    stat_err = 0.0
    for axis, (avg, std) in zip((1, 2, 3), stats):
        r_avg, r_std = gates.gate_stats_plain(x, axis)
        scale = gates.gate_stats_plain(x.abs(), axis)[0]
        stat_err = max(stat_err, ((avg - r_avg).abs() / scale.clamp_min(1e-30)).max().item(),
                       ((std - r_std).abs() / r_std.abs().clamp_min(1e-30)).max().item())
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    check(all(bool(torch.isfinite(g).all()) for g in got), "mca_gates: gates not finite")
    check(gate_err <= GATE_TOL, f"mca_gates {tuple(x.shape)} {x.dtype}: gate err {gate_err}")
    check(stat_err <= GATE_STAT_TOL,
          f"mca_gates {tuple(x.shape)} {x.dtype}: mean/std relative err {stat_err}")
    check(same, f"mca_gates {tuple(x.shape)} {x.dtype}: two launches differ")
    return {"gate_err_over_tol": gate_err / GATE_TOL,
            "stat_err_over_tol": stat_err / GATE_STAT_TOL, "repeat_bitwise": same}


def gate_call(x, params):
    """The K7 call of an MCALayer site, in the form ``kernel_record`` takes:
    bytes one read of x and the three gates written (the two passes read it
    twice), about 11 flops an element."""
    gb, gh, gw = x.shape[0], x.shape[1], x.shape[2]
    out_bytes = 4 * gb * (gh + gw + x.shape[3])
    return ("mca_gates", ("gates", tuple(x.shape), str(x.dtype)),
            lambda: gates.mca_gates(x, params), lambda: gates.mca_gates_plain(x, params),
            None, nbytes(x) + out_bytes, 11.0 * x.numel(), x.dtype,
            {"variant": gates.mca_gates_variant(x.dtype, x.shape[-1], aligned16(x)),
             "two_read_bound_ms": (2 * nbytes(x) + out_bytes) / PEAK_BYTES * 1e3,
             **gate_checks(x, params)})


def edge_checks(x) -> dict:
    """K8 against its plain version on the same card, bit for bit, and two
    launches the same bits; fails the run otherwise."""
    got = edge.eafe_edge(x)
    again = edge.eafe_edge(x)
    torch.cuda.synchronize()
    ref = edge.eafe_edge_plain(x)
    same_plain, same_again = bits_equal(got, ref), bits_equal(got, again)
    check(same_plain, f"eafe_edge {tuple(x.shape)} {x.dtype}: not the plain version's bits "
                      f"(max abs err {(got.float() - ref.float()).abs().max().item()})")
    check(same_again, f"eafe_edge {tuple(x.shape)} {x.dtype}: two launches differ")
    return {"bitwise_plain": same_plain, "repeat_bitwise": same_again}


def bits_equal(a, b) -> bool:
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def edge_library(x):
    """The library's composite on the NCHW view of x: ``F.avg_pool2d`` and
    the subtraction, two launches."""
    xc = x.permute(0, 3, 1, 2)
    return xc - F.avg_pool2d(xc, 3, 1, 1, count_include_pad=True)


def edge_call(x):
    """The K8 call of an EdgeAwareFeatureEnhancer site, in the form
    ``kernel_record`` takes: one read of x and one write, about 20 flops an
    element (nine adds, a division, a subtraction, two roundings)."""
    return ("eafe_edge", ("eafe", tuple(x.shape), str(x.dtype)),
            lambda: edge.eafe_edge(x), lambda: edge.eafe_edge_plain(x),
            lambda: edge_library(x), 2 * nbytes(x), 20.0 * x.numel(), x.dtype,
            {"variant": edge.eafe_edge_variant(x.dtype, x.shape[-1], aligned16(x)),
             **edge_checks(x)})


def site_call(site, cast):
    """The one kernel call of an MCALayer, ConvBNReLU or BasicConv site."""
    name, mod, args, kwargs = site
    if isinstance(mod, MCALayer):
        x = cast(args[0].contiguous())
        with torch.inference_mode():
            g = [mod.h_cw(x), mod.w_hc(x), mod.c_hw(x)]
        return ("mca_fused", ("mca", tuple(x.shape), str(x.dtype)),
                lambda: mca.mca_fused(x, *g), lambda: mca.mca_plain(x, *g), None,
                2 * nbytes(x) + nbytes(*g), 40.0 * x.numel(), x.dtype,
                {"variant": mca.mca_variant(x.dtype, x.shape[-1], 4, aligned16(x))})
    conv = mod.Conv_0
    k, b = cast(conv.kernel), conv.bias.float()
    up_pair = kwargs.get("up_pair")
    if up_pair is not None:
        x2, x1 = cast(up_pair[0].contiguous()), cast(up_pair[1].contiguous())
        c2, c1, co = x2.shape[-1], x1.shape[-1], k.shape[-1]
        out_numel = x2.shape[0] * x2.shape[1] * x2.shape[2] * co
        needed, executed = upconv.upconv_flops(tuple(x2.shape), c1, co, x2.element_size())
        x1_nchw, x2_nchw = x1.permute(0, 3, 1, 2), x2.permute(0, 3, 1, 2)
        k_oihw = k.permute(3, 2, 0, 1).contiguous()
        b_lib = b.to(x2.dtype)  # the kernel's bias, rounded to the working dtype

        def up_library():  # upsample, concat, cuDNN conv + bias + ReLU, timed only
            up = F.interpolate(x1_nchw, scale_factor=2, mode="bilinear", align_corners=True)
            return F.relu(F.conv2d(torch.cat([x2_nchw, up], 1), k_oihw, b_lib, padding=1))
        return ("up_concat_conv",
                ("up", tuple(x2.shape), tuple(x1.shape), co, str(x2.dtype)),
                lambda: upconv.up_concat_conv(x2, x1, k, b),
                lambda: upconv.up_concat_conv_plain(x2, x1, k, b), up_library,
                nbytes(x2, x1, k, b) + out_numel * x2.element_size(), needed, x2.dtype,
                {"executed_flops": executed,
                 "tile": list(upconv.upconv_tile(c2, c1, co, x2.element_size())),
                 "variant": upconv.upconv_variant(x2.dtype)})
    x = cast(args[0].contiguous())
    relu = mod.relu if isinstance(mod, BasicConv) else True
    co = k.shape[-1]
    out_numel = x.numel() // x.shape[-1] * co
    w_oihw = k.permute(3, 2, 0, 1).contiguous()
    bias_lib = b.to(x.dtype)

    def library():  # cuDNN's conv of the same inputs, timed only
        return F.conv2d(x.permute(0, 3, 1, 2), w_oihw, bias_lib, padding=1)
    needed, executed = conv3x3.conv3x3_flops(tuple(x.shape), co, x.element_size())
    return ("conv3x3_gemm", ("conv", tuple(x.shape), co, relu, str(x.dtype)),
            lambda: conv3x3.conv3x3_gemm(x, k, b, relu=relu),
            lambda: conv3x3.conv3x3_plain(x, k, b, relu=relu), library,
            nbytes(x, k, b) + out_numel * x.element_size(), needed, x.dtype,
            {"executed_flops": executed,
             "tile": list(conv3x3.conv3x3_tile(x.shape[-1], co, x.element_size())),
             "variant": conv3x3.conv3x3_variant(x.dtype)})


def csa_call(shape, dtype, seed: int = SEED, views: bool = False, odd_base: bool = False):
    """The K6 call at ``shape`` = (B, S, D, heads) on seeded inputs, in the
    form ``kernel_record`` takes.  ``views``: q, k, v are the three ``chunk``
    views of one [B, S, 3 D] tensor, as a transformer block's fused
    ``in_proj`` hands them over; otherwise three contiguous tensors.
    ``odd_base``: each tensor starts one element into its storage, off the
    16-byte grid.  The library yardstick is two
    ``scaled_dot_product_attention`` calls and an add on the same tensors,
    timed only."""
    b, s_, d, h = shape
    gen = torch.Generator().manual_seed(seed)
    q, k, v = [(torch.randn(b, s_, d, generator=gen) * sc).to(dtype).cuda()
               for sc in (1.5, 1.0, 1.0)]
    shift = lambda t: torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape)
    if views:
        qkv = torch.cat([q, k, v], dim=-1)
        q, k, v = (shift(qkv) if odd_base else qkv).chunk(3, dim=-1)
        check(not q.is_contiguous() and k.data_ptr() == q.data_ptr()
              + d * q.element_size(), "q, k, v are not views of one tensor")
    elif odd_base:
        q, k, v = map(shift, (q, k, v))
    check(aligned16(q) != odd_base, f"q's base on the 16-byte grid: {aligned16(q)}")
    heads = lambda t: t.unflatten(-1, (h, d // h)).transpose(1, 2)

    def library():
        return (F.scaled_dot_product_attention(heads(q), heads(q), heads(v))
                + F.scaled_dot_product_attention(heads(k), heads(k), heads(v)))
    extra = {"variant": csa.csa_variant(dtype),
             "layout": "in_proj_views" if views else "contiguous"}
    if dtype == torch.float32:
        extra["tile"] = list(csa.csa_f32_tiles(s_, d // h))
        extra["executed_flops"] = b * h * csa.csa_f32_flops(s_, d // h)[1]
    return ("csa_attention", ("csa", (b, s_, d), h, str(dtype)),
            lambda: csa.csa_attention(q, k, v, h), lambda: csa.csa_plain(q, k, v, h),
            library, 4 * nbytes(q), 6.0 * b * h * s_ * s_ * (d // h), dtype, extra)


def compare(kernel_fn, plain_fn, dtype) -> tuple:
    got = kernel_fn()
    torch.cuda.synchronize()
    ref = plain_fn()
    if isinstance(got, tuple):  # K7's float32 gates: absolute
        err = max((a - b).abs().max().item() for a, b in zip(got, ref))
        check(all(bool(torch.isfinite(a).all()) for a in got), "kernel output is not finite")
        return err, GATE_TOL, max(b.abs().max().item() for b in ref)
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    check(bool(torch.isfinite(got).all()), "kernel output is not finite")
    # bf16: one rounding step of the output's magnitude (both round the same
    # float32 sums, taken in another order); float32: 1e-4 relative
    tol = 2.0 ** -7 * max(scale, 1e-3) if dtype == torch.bfloat16 \
        else 1e-4 * max(scale, 1.0)
    return err, tol, scale


def kernel_record(site: str, call, reps: int, **extra) -> dict:
    """Check one kernel call against its plain version, time both (and the
    library call), print the record; fails the run past the tolerance."""
    name, key, kfn, pfn, lfn, nb, flops, dtype = call[:8]
    extra = {**extra, **(call[8] if len(call) > 8 else {})}
    err, tol, scale = compare(kfn, pfn, dtype)
    t_bound, by = bound(nb, flops, dtype)
    r = {"phase": "kernel", "name": name, "site": site, **extra,
         "dtype": str(dtype).split(".")[1],
         "shape": [list(s) if isinstance(s, tuple) else s for s in key[1:-1]],
         "max_abs_err": err, "tol": tol, "out_max_abs": scale,
         "kernel_ms": time_ms(kfn, reps=reps), "device_ms": device_time_ms(kfn, reps=reps),
         "plain_ms": time_ms(pfn, reps=reps // 2),
         "library_ms": None if lfn is None else time_ms(lfn, reps=reps),
         "library_device_ms": None if lfn is None else device_time_ms(lfn, reps=reps),
         "bound_ms": t_bound, "bound_by": by, "bytes": nb, "flops": flops}
    emit(r)
    check(err <= tol, f"{name} {r['dtype']} at {site}: max abs err {err} > tol {tol}")
    return r


def phase_kernels(pred, pair_pred, images) -> list:
    """Every kernel at every shape its main path gives it: the sites of the
    default route's forward, and the pair and upsample sites of the pair /
    fused-upsample route's (its other sites are the default route's)."""
    x = bucket_batch(pred, images)
    sites = (capture_sites(pred.model, x)
             + capture_sites(pair_pred.model, x, kinds=(DoubleConv,)))
    seen = {}
    for site in sites:
        for call in site_calls(site):
            key = call[1]
            if key in seen:
                seen[key]["count"] += 1
            else:
                seen[key] = {"site": site[0], "call": call, "count": 1, "raw": site}
    counts = {}
    for rec in seen.values():
        counts[rec["call"][0]] = counts.get(rec["call"][0], 0) + rec["count"]
    # K9's sites are held in phase_conv1x1
    want = {k: n for k, n in PER_FORWARD.items() if n and k != "conv1x1_gemm"}
    want.update({k: PER_FORWARD_PAIR[k] for k in ("conv3x3_pair_gemm", "upsample2x_fused")})
    check(counts == want, f"kernel sites per forward {counts} != {want}")

    records = [kernel_record(rec["site"], rec["call"], 10,
                             sites_per_forward=rec["count"]) for rec in seen.values()]
    # one float32 case per kernel, at its first site
    firsts = {}
    for rec in seen.values():
        firsts.setdefault(rec["call"][0], rec)
    for name, rec in firsts.items():
        call = next(c for c in site_calls(rec["raw"], torch.float32) if c[0] == name)
        records.append(kernel_record(rec["site"], call, 5))
    del sites, seen, firsts
    torch.cuda.empty_cache()
    # K6 at the CLIPSeg forward's shape, as the blocks give it (the chunk views
    # of in_proj's output): ten sites in bf16; once on contiguous tensors and
    # once in float32 beside it
    site = "clip.visual.resblock0..9"
    records.append(kernel_record(
        site, csa_call(CSA_PATH_SHAPE, torch.bfloat16, views=True), 10,
        sites_per_forward=PER_CLIPSEG_FORWARD["csa_attention"]))
    records.append(kernel_record(site, csa_call(CSA_PATH_SHAPE, torch.bfloat16), 10))
    records.append(kernel_record(site, csa_call(CSA_PATH_SHAPE, torch.float32, views=True), 5))
    torch.cuda.empty_cache()
    for r in records:
        want = PATH_VARIANTS[r["name"]][r["dtype"]]
        check(r.get("variant") == want,
              f"{r['name']} {r['dtype']} at {r['site']}: variant {r.get('variant')}")
    with open(OUT_DIR / "chip_smoke_kernels.jsonl", "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    return records


def phase_edges() -> None:
    """Each kernel against its plain version at small odd shapes: partial
    pixel and channel tiles, C=3, every tile the choosers of K2, K3 and K5
    can pick; for K5, C2 != C1, C2 off the 16-grid, h = 1 and w = 1; for K6,
    sequence lengths off the 64-row tiles, every head-width template,
    strided views on and off the 16-byte grid, and in float32 every tile
    boundary of the FFMA kernel (S = 1, 8, 9, 16, 17, 32, 33, 64, 65, 96, 97,
    the paths' 197 and 485, hd 9, bases off the 16-byte grid); for
    the pair kernel, maps smaller than a tile (down to 1x1), Cm != Co, and
    mid widths that force each smaller tile (400 and 800: 8x8 in float32 and
    bfloat16; 1300: 4x4; 3000: 2x2 in float32); for K1 and K4, both of
    their kernels (the 16-byte one and the scalar one, at least three cases
    each per dtype): K1 with C on and off the 32-grid and the 8-grid, groups
    1, 2 and 8, ragged tiles, h = 1, w = 1 and x off the 16-byte grid; K4
    with h = 1, w = 1, ragged bands, each C of the path, C = 3, 6 and 300
    and x off the 16-byte grid."""
    gen = torch.Generator().manual_seed(SEED)
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=gen) * scale).cuda()
    worst, variants, n_cases = {}, {}, 0
    for dtype in (torch.float32, torch.bfloat16):
        cases = []
        # K2: every tile conv3x3_tile picks (resident 16 / 32 / 64 columns;
        # the TMA unit's 8x16 x 32, 16x16 x 64, 8x16 x 128; cp.async 8x16 x
        # 64), C = 3, Co = 8 and 16, channel counts off the 8-grid, Co above
        # the widest chunk, a 1x1 map, x off the 16-byte grid, with and
        # without bias and ReLU
        for b_, h, w_, c, co, bias, relu in (
                (2, 7, 9, 3, 7, True, True), (2, 7, 9, 5, 20, True, True),
                (2, 7, 9, 33, 70, True, True), (1, 9, 11, 8, 5, False, False),
                (2, 11, 13, 64, 8, True, True), (1, 9, 20, 128, 16, True, True),
                (1, 1, 1, 16, 24, True, True), (1, 5, 30, 24, 40, True, False),
                (1, 9, 20, 256, 32, True, True), (1, 17, 19, 128, 64, True, True),
                (2, 9, 20, 64, 136, True, False), (1, 3, 2, 64, 136, False, True)):
            x, w = rnd(b_, h, w_, c).to(dtype), rnd(3, 3, c, co, scale=(2 / (9 * c)) ** 0.5)
            b = rnd(co) if bias else None
            cases.append(("conv3x3_gemm", lambda x=x, w=w, b=b, r=relu: conv3x3.conv3x3_gemm(
                x, w, b, relu=r), lambda x=x, w=w, b=b, r=relu: conv3x3.conv3x3_plain(
                x, w, b, relu=r)))
        x = rnd(x.numel() + 1).to(dtype)[1:].view(x.shape)  # off the 16-byte grid
        cases.append(("conv3x3_gemm", lambda x=x, w=w: conv3x3.conv3x3_gemm(x, w, relu=True),
                      lambda x=x, w=w: conv3x3.conv3x3_plain(x, w, relu=True)))
        # K1: C on the 32-grid (the TMA tiles; ragged 16 x 14 tiles, two
        # rows of tiles, a map smaller than a tile, h = 1, w = 1); off it on
        # and off the 8-grid, groups 1, 2 and 8, x off the 16-byte grid (the
        # scalar tiles)
        k1 = [(2, 9, 13, 20, 4), (1, 5, 17, 36, 4), (2, 9, 13, 32, 4), (1, 21, 35, 64, 4),
              (1, 3, 2, 96, 4), (2, 1, 19, 32, 4), (1, 17, 1, 64, 4), (1, 6, 5, 24, 4),
              (1, 7, 9, 3, 1), (1, 7, 9, 64, 2), (1, 18, 9, 64, 8), (1, 37, 17, 32, 4)]
        for i, (b_, h, w_, c, groups) in enumerate(k1 + [(1, 9, 11, 64, 4)]):
            x = rnd(b_, h, w_, c).to(dtype)
            if i == len(k1):  # off the 16-byte grid
                x = rnd(x.numel() + 1).to(dtype)[1:].view(x.shape)
            g = [torch.rand(b_, n, generator=gen).cuda() for n in (h, w_, c)]
            cases.append(("mca_fused", lambda x=x, g=g, n=groups: mca.mca_fused(x, *g, n),
                          lambda x=x, g=g, n=groups: mca.mca_plain(x, *g, n),
                          mca.mca_variant(dtype, c, groups, aligned16(x))))
        # K5: every tile upconv_tile picks (resident 16 / 32 / 64; the TMA
        # unit's 64 and 128 columns; cp.async 64 and 128), C2 != C1, C2 % 16
        # != 0 (on and off the 8-grid), h = 1, w = 1, Co above the widest chunk
        k5 = [(2, 5, 7, 6, 10, 9), (1, 3, 4, 40, 24, 33), (2, 1, 6, 16, 24, 40),
              (1, 5, 1, 8, 8, 16), (1, 1, 1, 16, 16, 16), (2, 7, 5, 32, 32, 32),
              (1, 6, 9, 64, 64, 64), (1, 5, 9, 32, 48, 136), (1, 4, 7, 40, 24, 72)]
        for i, (b_, h, w_, c1, c2, co) in enumerate(k5):
            x1, x2 = rnd(b_, h, w_, c1).to(dtype), rnd(b_, 2 * h, 2 * w_, c2).to(dtype)
            if i == len(k5) - 1:  # once more off the 16-byte grid: cp.async, 128 columns
                x2_off = rnd(x2.numel() + 1).to(dtype)[1:].view(x2.shape)
            k = rnd(3, 3, c1 + c2, co, scale=(2 / (9 * (c1 + c2))) ** 0.5)
            bias = rnd(co)
            for a in ((x2, x1), (x2_off, x1)) if i == len(k5) - 1 else ((x2, x1),):
                cases.append(("up_concat_conv",
                              lambda a=a, k=k, s=bias: upconv.up_concat_conv(*a, k, s),
                              lambda a=a, k=k, s=bias: upconv.up_concat_conv_plain(*a, k, s)))
        for b_, h, w_, c, cm, co in ((2, 7, 9, 3, 7, 5), (1, 1, 1, 4, 4, 4),
                                     (1, 2, 2, 3, 8, 6), (1, 3, 3, 5, 20, 33),
                                     (2, 17, 19, 33, 70, 40), (1, 5, 30, 16, 32, 32),
                                     (1, 9, 9, 8, 400, 16), (1, 9, 9, 8, 800, 16),
                                     (1, 5, 5, 8, 1300, 8), (1, 4, 4, 4, 3000, 4),
                                     # the stem's class (C % 8 != 0, Cm % 8 == 0), odd map
                                     (2, 23, 37, 3, 32, 32), (1, 19, 21, 40, 72, 24),
                                     # 128-column chunks; resident weights, 64 / 32
                                     # columns; 16x16 tiles
                                     (1, 9, 20, 16, 200, 24), (1, 9, 20, 16, 208, 136),
                                     (1, 11, 18, 8, 40, 24), (2, 17, 19, 32, 72, 40)):
            x = rnd(b_, h, w_, c).to(dtype)
            w1, w2 = rnd(3, 3, c, cm, scale=(2 / (9 * c)) ** 0.5), rnd(
                3, 3, cm, co, scale=(2 / (9 * cm)) ** 0.5)
            b1, b2 = rnd(cm, scale=0.1), rnd(co, scale=0.1)
            cases.append(("conv3x3_pair_gemm",
                          lambda a=(x, w1, b1, w2, b2): conv3x3.conv3x3_pair_gemm(*a),
                          lambda a=(x, w1, b1, w2, b2): conv3x3.conv3x3_pair_plain(*a)))
        # the last case again with x off the 16-byte grid: no tile of the TMA unit
        x = rnd(x.numel() + 1).to(dtype)[1:].view(x.shape)
        cases.append(("conv3x3_pair_gemm",
                      lambda a=(x, w1, b1, w2, b2): conv3x3.conv3x3_pair_gemm(*a),
                      lambda a=(x, w1, b1, w2, b2): conv3x3.conv3x3_pair_plain(*a)))
        # K4: C = 3 and 300 (scalar), h = 1, w = 1, ragged bands (2h % 16 !=
        # 0), each C of the path (256 / 128 / 64 / 32) on small maps, x off the
        # 16-byte grid (scalar)
        ups = [rnd(*shape).to(dtype) for shape in (
            (2, 5, 7, 3), (1, 1, 4, 8), (2, 9, 13, 16), (1, 3, 1, 40), (1, 1, 9, 32),
            (1, 7, 1, 64), (1, 23, 5, 8), (1, 3, 5, 256), (1, 4, 6, 128), (2, 5, 7, 64),
            (1, 9, 11, 32), (1, 3, 4, 300), (1, 5, 3, 6))]
        ups.append(rnd(2 * 6 * 5 * 16 + 1).to(dtype)[1:].view(2, 6, 5, 16))  # unaligned
        for x in ups:
            cases.append(("upsample2x_fused", lambda x=x: resize2x.upsample2x_fused(x),
                          lambda x=x: resize2x.upsample2x_plain(x),
                          resize2x.upsample_variant(dtype, x.shape[-1], aligned16(x))))
        for shape in ((2, 10, 32, 4), (1, 64, 64, 1), (1, 17, 64, 2),
                      (3, 197, 768, 12), (2, 70, 200, 2)):  # head widths 8..100
            call = csa_call(shape, dtype, seed=SEED + 1)
            cases.append((call[0], call[2], call[3]))
        # strided views: 64-wide heads, head widths off the 16-byte grid (100,
        # 9: an odd base for k and v), S < 16, S on and just past a key tile
        for shape in ((2, 100, 128, 2), (2, 70, 200, 2), (3, 33, 27, 3),
                      (2, 5, 64, 1), (1, 64, 128, 2), (1, 65, 128, 2)):
            call = csa_call(shape, dtype, seed=SEED + 2, views=True)
            cases.append((call[0], call[2], call[3]))
        # the FFMA kernel's tile boundaries: S = 1; the ragged last key step's
        # 8- and 16-key groups (S = 8, 9, 16, 17); on and one past the key
        # step and a warp's 32 query rows (32, 33, where one warp a state
        # idles) and the 64-row query tile (64, 65, 96, 97); the paths' S at
        # batch 1; hd off the 16-byte grid (9); views and tensors whose base
        # is off it
        if dtype == torch.float32:
            for shape, views, odd in (
                    ((2, 1, 64, 1), True, False), ((2, 8, 64, 1), False, False),
                    ((2, 9, 64, 1), True, False), ((2, 16, 64, 1), False, False),
                    ((2, 17, 64, 1), True, False), ((1, 32, 128, 2), True, False),
                    ((1, 33, 128, 2), True, False), ((1, 64, 64, 1), True, False),
                    ((1, 65, 64, 1), True, False), ((1, 96, 128, 2), False, False),
                    ((1, 97, 128, 2), True, False), ((1, 197, 768, 12), True, False),
                    ((1, 485, 768, 12), True, False), ((2, 40, 18, 2), False, False),
                    ((2, 50, 64, 1), False, True), ((1, 197, 768, 12), True, True),
                    ((2, 20, 64, 1), True, True)):
                call = csa_call(shape, dtype, seed=SEED + 3, views=views, odd_base=odd)
                cases.append((call[0], call[2], call[3]))
        n_cases += len(cases)
        for name, kfn, pfn, *variant in cases:
            err, tol, _ = compare(kfn, pfn, dtype)
            check(err <= tol, f"{name} {dtype} edge case: max abs err {err} > tol {tol}")
            key = f"{name}/{str(dtype).split('.')[1]}"
            worst[key] = max(worst.get(key, 0.0), err / tol)
            if variant:
                vkey = f"{key}/{variant[0]}"
                variants[vkey] = variants.get(vkey, 0) + 1
    # each K1 and K4 kernel took edge cases in both dtypes
    for name, kinds in (("mca_fused", ("tile_tma", "tile_scalar")),
                        ("upsample2x_fused", ("band_cp_async", "band_scalar"))):
        for dt in ("float32", "bfloat16"):
            for kind in kinds:
                check(variants.get(f"{name}/{dt}/{kind}", 0) >= 3,
                      f"edge cases of {name} {dt} took {kind} fewer than 3 times: {variants}")
    emit({"phase": "edge_shapes", "cases": n_cases, "worst_err_over_tol": worst,
          "variants": variants})


# K7's inputs in the EGM-UNet forward at the serving bucket, per image
GATE_PATH = [(288, 384, 64), (144, 192, 128), (72, 96, 256), (36, 48, 256)]


def gate_params(c: int, dtype, gen) -> list:
    """Seeded (weight, conv) pairs of the H, W and C gates at C channels, as
    ``init_reference`` draws them, on the card in ``dtype``."""
    out = []
    for k in (3, 3, mca_kernel_size(c)):
        w = torch.rand(2, generator=gen)
        conv = (torch.rand(k, generator=gen) * 2 - 1) / math.sqrt(k)
        out.append((w.to("cuda", dtype), conv.to("cuda", dtype)))
    return out


def phase_gates() -> dict:
    """K7 against its plain version (``gate_checks``) at the four sites'
    shapes at batch 32 and batch 1, in both dtypes, timed at batch 32 beside
    the plain composite it replaces (the port's route before K7); then small
    and odd shapes: ragged H and W, H = 1, W = 1, C = 32, 24 (two lanes'
    worth of 8), 96, 512 and 2048 (lanes spanning 2 and 8 warps) on the
    16-byte variant, C = 3, 20 and 300 and x off the 16-byte grid on the
    scalar one, signed data, float32 maps with bfloat16 parameters."""
    gen = torch.Generator().manual_seed(SEED + 7)
    cuda_gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rnd = lambda *shape: torch.randn(*shape, generator=cuda_gen, device="cuda")
    timed, worst, variants, n_cases = [], {}, {}, 0

    def case(x, params, time_it=False):
        nonlocal n_cases
        r = gate_checks(x, params)
        key = str(x.dtype).split(".")[1]
        v = gates.mca_gates_variant(x.dtype, x.shape[-1], aligned16(x))
        variants[f"{key}/{v}"] = variants.get(f"{key}/{v}", 0) + 1
        worst[key] = max(worst.get(key, 0.0), r["gate_err_over_tol"], r["stat_err_over_tol"])
        n_cases += 1
        if x.shape[0] > 8:  # an image's gates are the same bits in any batch
            full = gates.mca_gates(x, params)
            for lo, hi in ((5, 8), (11, 12)):
                part = gates.mca_gates(x[lo:hi], params)
                check(all(torch.equal(a, f[lo:hi]) for a, f in zip(part, full)),
                      f"mca_gates {tuple(x.shape)} {x.dtype}: images {lo}..{hi - 1} alone "
                      "differ from the same images in the batch")
            r["batch_invariant"] = True
        if time_it:
            nb = nbytes(x) + 4 * x.shape[0] * sum(x.shape[1:])
            timed.append({"shape": list(x.shape), "dtype": key, "variant": v, **r,
                          "device_ms": device_time_ms(lambda: gates.mca_gates(x, params)),
                          "plain_device_ms": device_time_ms(
                              lambda: gates.mca_gates_plain(x, params), reps=5),
                          "bound_ms": nb / PEAK_BYTES * 1e3,
                          "two_read_bound_ms": (nb + nbytes(x)) / PEAK_BYTES * 1e3})

    for dtype in (torch.bfloat16, torch.float32):
        for h, w, c in GATE_PATH:
            for b in (32, 1):
                case(rnd(b, h, w, c).relu().to(dtype), gate_params(c, dtype, gen),
                     time_it=b == 32)
            torch.cuda.empty_cache()
        for b, h, w, c in ((2, 7, 13, 64), (3, 1, 5, 32), (1, 5, 1, 32), (2, 37, 29, 32),
                           (2, 9, 11, 24), (1, 6, 7, 96), (2, 5, 9, 512), (1, 3, 4, 2048),
                           (2, 7, 9, 3), (1, 11, 6, 20), (1, 4, 5, 300)):
            case(rnd(b, h, w, c).relu().to(dtype), gate_params(c, dtype, gen))
        x = rnd(2 * 9 * 11 * 64 + 1).relu().to(dtype)[1:].view(2, 9, 11, 64)  # off the grid
        case(x, gate_params(64, dtype, gen))
        case(rnd(2, 17, 19, 64).to(dtype), gate_params(64, dtype, gen))  # signed
    case(rnd(2, 36, 48, 256).relu(), gate_params(256, torch.bfloat16, gen))  # mixed
    for dt in ("bfloat16", "float32"):
        for v in ("vec16", "scalar"):
            check(variants.get(f"{dt}/{v}", 0) >= 3, f"gates cases of {dt} {v}: {variants}")
    per_batch = {dt: sum(r["device_ms"] for r in timed if r["dtype"] == dt)
                 for dt in ("bfloat16", "float32")}
    rec = {"phase": "gates", "cases": n_cases, "worst_err_over_tol": worst,
           "variants": variants, "batch32": timed, "device_ms_per_batch32": per_batch,
           "plain_device_ms_per_batch32": {
               dt: sum(r["plain_device_ms"] for r in timed if r["dtype"] == dt)
               for dt in ("bfloat16", "float32")}}
    emit(rec)
    return rec


# K8's inputs in the EGM-UNet forward at the serving bucket, per image: each
# EGRFB's edge_enhancer (C) and edge_eafe (C / 8)
EDGE_PATH = [(288, 384, 64), (288, 384, 8), (144, 192, 128), (144, 192, 16),
             (72, 96, 256), (72, 96, 32), (36, 48, 256), (36, 48, 32)]


def phase_eafe() -> dict:
    """K8 against its plain version, bit for bit (``edge_checks``), at the
    eight path shapes at batch 8 and 32 in both dtypes on ReLU'd data (the
    forward's, whose window sums are often zero), an image alone and in a
    batch the same bits; timed at batch 32 (device ms, bound, the plain
    composite, the library's ``avg_pool2d`` and subtraction); then signed
    data at the largest path shape, small and odd shapes (ragged tiles and
    bands, H = 1, W = 1, C = 24 and 2048 on the 16-byte variant, C = 3, 20
    and x off the 16-byte grid on the scalar one) and special values (+-0,
    +-inf, large magnitudes)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)

    def rnd(*shape):
        x = torch.randn(*shape, generator=gen, device="cuda")
        return x * torch.rand(*shape, generator=gen, device="cuda").mul(8).exp2()

    timed, variants, n_cases = [], {}, 0

    def case(x, time_it=False):
        nonlocal n_cases
        r = edge_checks(x)
        key = str(x.dtype).split(".")[1]
        v = edge.eafe_edge_variant(x.dtype, x.shape[-1], aligned16(x))
        variants[f"{key}/{v}"] = variants.get(f"{key}/{v}", 0) + 1
        n_cases += 1
        if x.shape[0] > 1:  # an image's edge is the same bits in any batch
            full = edge.eafe_edge(x)
            for lo, hi in ((x.shape[0] // 2, x.shape[0] // 2 + 3), (x.shape[0] - 1, x.shape[0])):
                part = edge.eafe_edge(x[lo:hi].contiguous())
                check(bits_equal(part, full[lo:hi]),
                      f"eafe_edge {tuple(x.shape)} {x.dtype}: images {lo}..{hi - 1} alone "
                      "differ from the same images in the batch")
        if time_it:
            nb = 2 * nbytes(x)
            timed.append({"shape": list(x.shape), "dtype": key, "variant": v, **r,
                          "device_ms": device_time_ms(lambda: edge.eafe_edge(x)),
                          "plain_device_ms": device_time_ms(lambda: edge.eafe_edge_plain(x)),
                          "library_device_ms": device_time_ms(lambda: edge_library(x)),
                          "bound_ms": nb / PEAK_BYTES * 1e3})

    for dtype in (torch.bfloat16, torch.float32):
        for h, w, c in EDGE_PATH:  # after a ReLU, as the forward gives them
            for b in (32, 8):
                case(rnd(b, h, w, c).relu().to(dtype), time_it=b == 32)
            torch.cuda.empty_cache()
        case(rnd(8, 288, 384, 64).to(dtype))  # signed
        for b, h, w, c in ((2, 7, 13, 64), (3, 1, 5, 32), (1, 5, 1, 32), (2, 37, 29, 256),
                           (2, 9, 11, 24), (1, 6, 70, 64), (2, 5, 9, 2048), (2, 70, 9, 8),
                           (2, 7, 9, 3), (1, 11, 6, 20), (1, 4, 5, 300)):
            case(rnd(b, h, w, c).to(dtype))
        x = rnd(2 * 9 * 11 * 64 + 1).to(dtype)[1:].view(2, 9, 11, 64)  # off the grid
        case(x)
        x = rnd(2, 17, 19, 64).to(dtype)
        x[:, ::3, :, ::5] = 0.0
        x[:, 1::4, :, 1::7] = -0.0
        x[0, 5, 7, :8] = float("inf")
        x[1, 9, 3, 8:16] = -float("inf")
        x[1, 2, 2, :] = 3e38
        case(x)
    for dt in ("bfloat16", "float32"):
        for v in ("vec16", "scalar"):
            check(variants.get(f"{dt}/{v}", 0) >= 3, f"eafe cases of {dt} {v}: {variants}")
    sums = lambda key: {dt: sum(r[key] for r in timed if r["dtype"] == dt)
                        for dt in ("bfloat16", "float32")}
    rec = {"phase": "eafe", "cases": n_cases, "variants": variants, "batch32": timed,
           "device_ms_per_batch32": sums("device_ms"),
           "bound_ms_per_batch32": sums("bound_ms"),
           "plain_device_ms_per_batch32": sums("plain_device_ms"),
           "library_device_ms_per_batch32": sums("library_device_ms")}
    emit(rec)
    return rec


def conv1x1_sites(model, x) -> dict:
    """The K9 calls of one forward of ``model`` on ``x``: (H, W, K, N, bias,
    relu) -> calls, from a spy on the two modules that dispatch to it."""
    sites, wrapped = {}, conv1x1.conv1x1_gemm

    def spy(xx, w, b=None, *, relu=False):
        key = (xx.shape[1], xx.shape[2], w.shape[2], w.shape[3], b is not None, relu)
        sites[key] = sites.get(key, 0) + 1
        return wrapped(xx, w, b, relu=relu)
    layers.conv1x1_gemm = grfb.conv1x1_gemm = spy
    try:
        with torch.inference_mode():
            model(x)
    finally:
        layers.conv1x1_gemm = grfb.conv1x1_gemm = wrapped
    return sites


def conv1x1_operands(b, key, exact: bool, gen):
    """Seeded operands of a K9 site ``key`` at batch ``b``, bf16 (the bias in
    bf16, as the folded bf16 model holds it).  ``exact``: small integers and
    multiples of 1/64, whose float32 sums are exact in any order, so the
    kernel must give the plain version's bits."""
    h, w_, k, n, has_bias, _ = key
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    if exact:
        ints = lambda lo, hi, *shape: torch.randint(lo, hi, shape, generator=gen,
                                                    device="cuda").float()
        x = ints(1, 9, b, h, w_, k)
        w = ints(-8, 9, 1, 1, k, n) / 64
        bias = ints(-64, 65, n) / 64
    else:
        x = rnd(b, h, w_, k).relu()
        w = rnd(1, 1, k, n) / math.sqrt(k)
        bias = rnd(n) * 0.1
    return (x.to(torch.bfloat16), w.to(torch.bfloat16),
            bias.to(torch.bfloat16) if has_bias else None)


def conv1x1_call(x, w, bias, relu: bool):
    """The K9 call on these operands, in the form ``kernel_record`` takes;
    the library yardstick is the route it replaced, cuDNN's ``F.conv2d``
    with PyTorch's separate bias add (and ``F.relu``), timed only."""
    k, n = w.shape[2], w.shape[3]
    m = x.numel() // k
    x_nchw, w_oihw = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous()

    def library():
        y = F.conv2d(x_nchw, w_oihw, bias)
        return F.relu(y) if relu else y
    needed, executed = conv1x1.conv1x1_flops(m, k, n)
    return ("conv1x1_gemm", ("conv1x1", tuple(x.shape), n, relu, bias is not None,
                             str(x.dtype)),
            lambda: conv1x1.conv1x1_gemm(x, w, bias, relu=relu),
            lambda: conv1x1.conv1x1_plain(x, w, bias, relu=relu), library,
            nbytes(x, w, bias) + m * n * x.element_size(), needed, x.dtype,
            {"executed_flops": executed, "tile": list(conv1x1.conv1x1_tile(k, n, m)),
             "variant": "mma_bf16"})


def phase_conv1x1(pred, images, records) -> dict:
    """K9 at every site of the bf16 forward at the serving bucket: its sites
    (a spy on the dispatch) held to ``PER_FORWARD``; at batch 8 and 32 on
    exact operands the plain version's bits (two launches the same bits), on
    seeded ReLU'd maps one bf16 rounding step of the output's magnitude
    (``compare``); batch 8 as ``kernel_record``s (into ``records``, for the
    summary), batch 32 timed beside the library route it replaced (cuDNN's
    conv, the bias add, the ReLU) and the bytes bound."""
    x = bucket_batch(pred, images)
    sites = conv1x1_sites(pred.model, x)
    n_sites = sum(sites.values())
    check(n_sites == PER_FORWARD["conv1x1_gemm"],
          f"conv1x1_gemm sites per forward {n_sites} != {PER_FORWARD['conv1x1_gemm']}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    batch32 = []
    for key, count in sorted(sites.items(), reverse=True):
        relu = key[5]
        for b in (8, 32):
            xe, we, be = conv1x1_operands(b, key, True, gen)
            got = conv1x1.conv1x1_gemm(xe, we, be, relu=relu)
            again = conv1x1.conv1x1_gemm(xe, we, be, relu=relu)
            torch.cuda.synchronize()
            ref = conv1x1.conv1x1_plain(xe, we, be, relu=relu)
            check(bits_equal(got, ref), f"conv1x1_gemm {key} batch {b}: exact operands, not "
                                        "the plain version's bits")
            check(bits_equal(got, again), f"conv1x1_gemm {key} batch {b}: two launches differ")
            call = conv1x1_call(*conv1x1_operands(b, key, False, gen), relu)
            site = f"H{key[0]} W{key[1]} {key[2]}->{key[3]}"
            if b == 8:
                records.append(kernel_record(site, call, 10, sites_per_forward=count))
                continue
            err, tol, _ = compare(call[2], call[3], torch.bfloat16)
            check(err <= tol, f"conv1x1_gemm {key} batch 32: max abs err {err} > tol {tol}")
            r = {"site": site, "shape": [b, *key[:4]], "bias": key[4], "relu": relu,
                 "sites_per_forward": count, "tile": call[8]["tile"],
                 "max_abs_err": err, "tol": tol,
                 "device_ms": device_time_ms(call[2]),
                 "library_device_ms": device_time_ms(call[4]),
                 "bound_ms": call[5] / PEAK_BYTES * 1e3}
            r["faster_than_library"] = r["device_ms"] < r["library_device_ms"]
            batch32.append(r)
            del xe, we, be, got, again, ref, call
        torch.cuda.empty_cache()
    per_fwd = lambda key: sum(r[key] * r["sites_per_forward"] for r in batch32)
    rec = {"phase": "conv1x1", "sites_per_forward": n_sites, "shapes": len(sites),
           "batch32": batch32,
           "device_ms_per_batch32": per_fwd("device_ms"),
           "library_device_ms_per_batch32": per_fwd("library_device_ms"),
           "bound_ms_per_batch32": per_fwd("bound_ms"),
           "slower_than_library": [r["site"] for r in batch32 if not r["faster_than_library"]]}
    emit(rec)
    return rec


def phase_serving(pred, dev) -> dict:
    sizes = [(565, 752), (565, 752), (480, 640), (600, 500)]
    images = [synthetic_tp_sample(i, h, w)[0] for i, (h, w) in enumerate(sizes)]
    buckets = {}
    for img in images:
        key = bucket_of(pred.preprocess(img).shape)
        buckets[key] = buckets.get(key, 0) + 1
    forwards = sum(-(-n // BATCH) for n in buckets.values())

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    masks = pred.predict(images)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()

    expect = {k: v * forwards for k, v in PER_FORWARD.items()}
    check(launches == expect, f"launches {launches} != {expect} for {forwards} forwards")
    for img, mask in zip(images, masks):
        check(mask.shape == img.shape[:2], f"mask {mask.shape} for image {img.shape}")
        check(mask.dtype == np.uint8 and int(mask.max()) <= 1, "mask values not in {0,1}")

    x = bucket_batch(pred, images[:2])
    with torch.inference_mode():
        logits = pred.model(x)["out"]
    check(tuple(logits.shape) == (BATCH, *BUCKET, 2), f"logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "serving logits are not finite")
    ms = time_ms(lambda: pred.forward(x), reps=5, warm=1)
    rec = {"phase": "serving", "requests": len(images), "buckets": {
        f"{k[0]}x{k[1]}": n for k, n in buckets.items()}, "forwards": forwards,
        "launches": launches, "launches_per_forward": PER_FORWARD,
        "predict_wall_s": wall, "bucket": list(BUCKET), "batch": BATCH,
        "dtype": "bfloat16", "ms_per_batch": ms, "img_per_s": BATCH / ms * 1e3,
        "card": dev["nvidia_smi"],
        "foreground_share": float(np.mean([mk.mean() for mk in masks]))}
    emit(rec)
    phase_profile("profile", lambda: pred.forward(x), "serving_profile.txt",
                  {"conv3x3_gemm": "conv3x3_mma_kernel",
                   "up_concat_conv": "upconv_mma_kernel",
                   "mca_fused": "mca_tile_kernel",
                   "mca_gates": "mca_gate_",  # three launches a call
                   "eafe_edge": "eafe_edge_kernel",
                   "conv1x1_gemm": "conv1x1_gemm_kernel"})
    return rec


def http_request(port: int, method: str, path: str, body=None) -> tuple:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request(method, path, body=body)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def count_forwards(model) -> tuple:
    """(list that grows by one per forward of ``model``, the hook's handle)."""
    calls = []
    return calls, model.register_forward_hook(lambda m, a, out: calls.append(1))


def phase_serve(httpd, batcher, pred, dev) -> dict:
    """The pair / fused-upsample route behind the HTTP server: 12 concurrent
    PNG requests of two sizes (two shape buckets), each reply checked, the
    masks held against ``Predictor.predict``, the launch counts against the
    forwards the server ran, and the route's forward timed beside the default
    route's on the same batch."""
    pair_pred = batcher.predictor
    cfg = pair_pred.cfg
    check((cfg.conv_impl, cfg.upsample_impl, cfg.batch_size, cfg.dtype)
          == ("pair", "fused", BATCH, "bfloat16"), f"server predictor config {cfg}")
    port = httpd.server_port
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    status, body = http_request(port, "GET", "/healthz")
    check(status == 200 and body == b"warming", f"/healthz before traffic: {status} {body}")

    sizes = [(565, 752)] * 8 + [(600, 500)] * 4
    images = [synthetic_tp_sample(200 + i, h, w)[0] for i, (h, w) in enumerate(sizes)]
    bodies = []
    for img in images:
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        bodies.append(buf.getvalue())
    buckets = sorted({bucket_of(pair_pred.preprocess(img).shape) for img in images})
    check(BUCKET in buckets and len(buckets) == 2, f"request buckets {buckets}")

    replies = [None] * len(images)

    def client(i):
        replies[i] = http_request(port, "POST", "/predict", bodies[i])

    forwards, hook = count_forwards(pair_pred.model)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    clients = [threading.Thread(target=client, args=(i,)) for i in range(len(images))]
    for t in clients:
        t.start()
    for t in clients:
        t.join(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    hook.remove()
    n_fwd = len(forwards)

    check(all(r is not None and r[0] == 200 for r in replies),
          f"HTTP statuses {[None if r is None else r[0] for r in replies]}")
    masks = [np.asarray(Image.open(io.BytesIO(r[1]))) for r in replies]
    for img, mask in zip(images, masks):
        check(mask.shape == img.shape[:2], f"reply {mask.shape} for request {img.shape}")
        check(mask.dtype == np.uint8 and set(np.unique(mask)) <= {0, 255},
              "reply values not in {0, 255}")
    expect = {k: v * n_fwd for k, v in PER_FORWARD_PAIR.items()}
    check(n_fwd >= 2 and launches == expect,
          f"serve launches {launches} != {expect} for {n_fwd} forwards")

    status, body = http_request(port, "GET", "/healthz")
    check(status == 200 and body == b"ok", f"/healthz after traffic: {status} {body}")
    status, body = http_request(port, "GET", "/stats")
    check(status == 200, f"/stats status {status}")
    stats = json.loads(body)
    lat = stats["latency_ms"]
    check(stats["requests"] == len(images) and 1 <= stats["batches"] < len(images)
          and stats["mean_batch_occupancy"] > 1.0, f"/stats {stats}")
    check(0 < lat["p50"] <= lat["p95"] <= lat["p99"], f"latency percentiles {lat}")
    httpd.shutdown()
    batcher.shutdown()
    httpd.server_close()
    thread.join(timeout=10)
    check(not thread.is_alive(), "the server thread did not stop")

    # the same images through the predictor, without the server
    direct = pair_pred.predict(images)
    same = [bool(np.array_equal(m, d * 255)) for m, d in zip(masks, direct)]
    check(all(same), f"HTTP masks differ from Predictor.predict: {same}")

    # the two routes on one bucket batch: masks, then times in turns
    x = bucket_batch(pred, images[:BATCH])
    with torch.inference_mode():
        logits = pair_pred.model(x)["out"]
    check(tuple(logits.shape) == (BATCH, *BUCKET, 2) and bool(torch.isfinite(logits).all()),
          "pair-route logits are not finite [8, 576, 768, 2]")
    agreement = (pair_pred.forward(x) == pred.forward(x)).float().mean().item()
    check(agreement >= 0.99, f"route masks agree on {agreement} < 0.99 of pixels")
    ms_default = [time_ms(lambda: pred.forward(x), reps=5, warm=1)]
    ms_pair = [time_ms(lambda: pair_pred.forward(x), reps=5, warm=1) for _ in range(2)]
    ms_default.append(time_ms(lambda: pred.forward(x), reps=5, warm=1))
    rec = {"phase": "serve", "requests": len(images), "buckets": [list(b) for b in buckets],
           "forwards": n_fwd, "launches": launches,
           "launches_per_forward": PER_FORWARD_PAIR, "wall_s": wall, "stats": stats,
           "http_masks_equal_predict": True, "route": ["pair", "fused"],
           "bucket": list(BUCKET), "batch": BATCH, "dtype": "bfloat16",
           "ms_per_batch": statistics.median(ms_pair), "ms_per_batch_runs": ms_pair,
           "ms_per_batch_default_route": statistics.median(ms_default),
           "ms_per_batch_default_route_runs": ms_default,
           "img_per_s": BATCH / statistics.median(ms_pair) * 1e3,
           "route_mask_agreement": agreement, "card": dev["nvidia_smi"],
           "foreground_share": float(np.mean([(mk > 0).mean() for mk in masks]))}
    emit(rec)
    phase_profile("serve_profile", lambda: pair_pred.forward(x), "serve_profile.txt",
                  {"conv3x3_pair_gemm": "pair_mma_kernel",
                   "upsample2x_fused": "upsample2x_band_kernel",
                   "conv3x3_gemm": "conv3x3_mma_kernel", "mca_fused": "mca_tile_kernel"})
    return rec


def phase_predict_cli(dev) -> dict:
    """``cli/predict.py`` as a user runs it on synthetic images: bf16, the pair
    / fused-upsample route, one warm-up and one timed forward per image."""
    out_dir = OUT_DIR / "predict_cli"
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in out_dir.glob("*.png"):
        old.unlink()
    printed = io.StringIO()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        predict_cli.main(["--synthetic", "--amp", "--conv-impl", "pair",
                          "--upsample-impl", "fused", "--save-result", str(out_dir)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    lines = printed.getvalue().splitlines()
    times = [float(ln.split(": ")[1]) for ln in lines if ln.startswith("inference time: ")]
    check(len(times) == 4 and lines[-1].startswith("FPS: "), f"CLI output {lines}")
    expect = {k: v * 2 * len(times) for k, v in PER_FORWARD_PAIR.items()}
    check(launches == expect, f"predict CLI launches {launches} != {expect}")
    names = sorted(f.name for f in out_dir.glob("*.png"))
    check(names == [f"{i:04d}.png" for i in range(4)], f"predict CLI wrote {names}")
    shares = []
    for name in names:
        mask = np.asarray(Image.open(out_dir / name))
        check(mask.shape == (565, 752) and mask.dtype == np.uint8
              and set(np.unique(mask)) <= {0, 255}, f"{name}: {mask.shape} {mask.dtype}")
        shares.append(float((mask > 0).mean()))
    rec = {"phase": "predict_cli", "images": len(times), "launches": launches,
           "forwards": 2 * len(times), "inference_s": times,
           "fps": float(lines[-1].split(": ")[1]), "wall_s": wall,
           "route": ["pair", "fused"], "dtype": "bfloat16", "batch": 1,
           "card": dev["nvidia_smi"], "foreground_share": float(np.mean(shares))}
    emit(rec)
    return rec


def phase_profile(phase: str, forward, out_name: str, patterns: dict,
                  host: dict = None, require: bool = True) -> dict:
    """Device time of one call of ``forward`` by kernel, from torch.profiler;
    ``patterns`` names the kernels whose time and launches are summed by
    substring.  A pattern that matches no launch fails the run (unless not
    ``require``), so that a renamed kernel cannot drop out of the sums
    unseen.  ``host`` names host ranges (``record_function`` names, by
    prefix) whose host time and calls are summed."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, host_rows = [], []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CPU:
            host_rows.append((e.cpu_time_total / 1e3, e.count, e.key))
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    by_kernel = {name: sum(r[0] for r in rows if pat in r[2])
                 for name, pat in patterns.items()}
    calls = {name: sum(r[1] for r in rows if pat in r[2]) for name, pat in patterns.items()}
    missing = [f"{name} ({pat})" for name, pat in patterns.items() if not calls[name]]
    check(not (require and missing), f"{phase}: no launch matched {missing}")
    (OUT_DIR / out_name).write_text(
        f"wall {wall_ms:.3f} ms, device {device_ms:.3f} ms\n"
        + "\n".join(f"{ms:10.3f} ms {n:5d}x  {k}" for ms, n, k in rows) + "\n")
    rec = {"phase": phase, "wall_ms": wall_ms, "device_ms": device_ms,
           "device_idle_share": None if not rows else max(0.0, 1 - device_ms / wall_ms),
           "by_kernel_ms": by_kernel, "by_kernel_launches": calls,
           "launches": sum(r[1] for r in rows),
           "top": [{"ms": ms, "calls": n, "name": k[:80]} for ms, n, k in rows[:8]]}
    for name, prefix in (host or {}).items():
        rec[f"host_{name}_ms"] = sum(r[0] for r in host_rows if r[2].startswith(prefix))
        rec[f"host_{name}_calls"] = sum(r[1] for r in host_rows if r[2].startswith(prefix))
    emit(rec)
    return rec


def prompt_tokens(lengths=(3, 80)) -> torch.Tensor:
    """Seeded token ids framed like tokenized prompts: SOT, ids below SOT,
    EOT (the highest id), zero padding; the lengths of the predict CLI's
    default prompts ("background" and the long tactile-paving description)."""
    gen = torch.Generator().manual_seed(SEED)
    tok = torch.zeros((len(lengths), VIT_B16.context_length), dtype=torch.int64)
    for i, n in enumerate(lengths):
        tok[i, 0] = SOT
        tok[i, 1:n - 1] = torch.randint(1, SOT, (n - 2,), generator=gen)
        tok[i, n - 1] = EOT
    return tok


def phase_fusion(unet, dev) -> dict:
    """The text-prompted fusion path at full width, through the function the
    predict CLI calls."""
    t0 = time.perf_counter()
    clipseg = CLIPDensePredT(clip_cfg=VIT_B16, reduce_dim=64, extract_layers=(3, 6, 9))
    init_weights(clipseg, torch.Generator().manual_seed(SEED))
    clipseg = cast_weights(clipseg.to("cuda"), torch.bfloat16).eval()
    build_s = time.perf_counter() - t0

    tokens = prompt_tokens().cuda()
    torch.cuda.synchronize()
    reset_launch_counts()
    cond = clipseg.compute_conditional(tokens).float()
    torch.cuda.synchronize()
    text_launches = launch_counts()
    check(not any(text_launches.values()), f"the text tower launched {text_launches}")
    check(tuple(cond.shape) == (2, VIT_B16.embed_dim) and bool(torch.isfinite(cond).all()),
          "text conditionals are not finite [2, 512]")
    text_ms = time_ms(lambda: clipseg.compute_conditional(tokens), reps=5, warm=1)

    raws = [synthetic_tp_sample(100 + i)[0] for i in range(N_FUSION_IMAGES)]
    info = {}
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    masks = fused_masks(clipseg, unet, cond, raws, ALPHA, base_size=BASE_SIZE,
                        clip_size=CLIP_SIZE, clip_batch=CLIP_BATCH,
                        unet_batch=UNET_BATCH, device="cuda", info=info)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()

    expect = {k: PER_CLIPSEG_FORWARD[k] * info["clipseg_forwards"]
              + PER_FORWARD[k] * info["unet_forwards"] for k in PER_FORWARD}
    check(info["clipseg_forwards"] == -(-N_FUSION_IMAGES * 2 // CLIP_BATCH)
          and info["unet_forwards"] >= 1, f"forwards {info}")
    check(launches == expect, f"fusion launches {launches} != {expect} for {info}")
    check(info["logits_finite"], "fusion logits are not finite")
    check(len(masks) == N_FUSION_IMAGES, f"{len(masks)} masks")
    for raw, mask in zip(raws, masks):
        check(mask.shape == raw.shape[:2], f"mask {mask.shape} for image {raw.shape}")
        check(mask.dtype == np.uint8 and set(np.unique(mask)) <= {0, 255},
              "mask values not in {0, 255}")

    wire = phase_fusion_wire(clipseg, unet, cond)

    gen = torch.Generator().manual_seed(SEED + 2)
    x = torch.randn(CLIP_BATCH, CLIP_SIZE, CLIP_SIZE, 3, generator=gen).cuda()
    conds = cond.repeat(CLIP_BATCH // 2, 1)
    (logits,) = clipseg(x, conds)
    check(tuple(logits.shape) == (CLIP_BATCH, CLIP_SIZE, CLIP_SIZE, 1)
          and logits.dtype == torch.float32 and bool(torch.isfinite(logits).all()),
          f"CLIPSeg logits {tuple(logits.shape)} {logits.dtype} not finite float32")
    ms = time_ms(lambda: clipseg(x, conds), reps=5, warm=1)
    rec = {"phase": "fusion", "images": N_FUSION_IMAGES, "prompts": 2,
           "prompt_tokens": [3, 80], "alpha": ALPHA, "dtype": "bfloat16",
           "clip_size": CLIP_SIZE, "clip_batch": CLIP_BATCH, "unet_batch": UNET_BATCH,
           "base_size": BASE_SIZE, **info, "launches": launches,
           "launches_text_tower": text_launches,
           "launches_per_clipseg_forward": PER_CLIPSEG_FORWARD["csa_attention"],
           "clipseg_ms_per_batch": ms, "clipseg_img_per_s": CLIP_BATCH / ms * 1e3,
           "text_tower_ms": text_ms, "pipeline_wall_s": wall,
           "model_build_s": build_s, "card": dev["nvidia_smi"],
           "foreground_share": float(np.mean([(mk > 0).mean() for mk in masks])),
           "wire": wire}
    emit(rec)
    phase_profile("clipseg_profile", lambda: clipseg(x, conds), "clipseg_profile.txt",
                  {"csa_attention": "csa_mma_kernel",
                   # PyTorch's own copies and dtype casts; the blocks add none
                   # for q, k, v (they hand views to the kernel)
                   "copies_and_casts": "copy_kernel"})
    return rec


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def phase_fusion_wire(clipseg, unet, cond) -> dict:
    """The fusion's uint8 wire on the card: the inputs of every CLIPSeg and
    UNet forward of ``run_branches`` (kept by forward pre-hooks) against the
    float32 wire the host built before it (``preprocess``, the CLIP inputs
    ``np.repeat``-ed over the prompts and zero-padded to the batch, the
    prompt rows tiled, the float32 ``bucket_batches`` cast to the UNet's
    dtype on the card), bit for bit.  Three frames: a 565x752 ramp (the
    UNet's resize keeps it: every byte value in each channel), a 352x352
    ramp (the CLIP resize keeps it), a synthetic 480x640 frame; two buckets,
    part-filled UNet batches, one short CLIP chunk.  CUDA divides by a Python
    number as a product by the reciprocal, which no CPU test sees; the
    record counts the byte values that route puts off the host's bits."""
    v = np.arange(256, dtype=np.uint8)
    ramp = lambda h, w: np.resize(np.stack([v, v[::-1], np.roll(v, 85)], -1),  # noqa: E731
                                  (h * w, 3)).reshape(h, w, 3)
    raws = [ramp(565, 752), ramp(CLIP_SIZE, CLIP_SIZE), synthetic_tp_sample(7, 480, 640)[0]]
    u565s, u352s = resize_frames(raws, BASE_SIZE, CLIP_SIZE)
    check(len(np.unique(u565s[0])) == 256 and len(np.unique(u352s[1])) == 256,
          "the ramps lost byte values in their resizes")
    seen = {"clip": [], "unet": []}
    hooks = [m.register_forward_pre_hook(
        lambda _m, args, k=k: seen[k].append([a.clone() for a in args]))
        for k, m in (("clip", clipseg), ("unet", unet))]
    try:
        info = {}
        run_branches(clipseg, unet, cond, u565s, u352s, clip_batch=CLIP_BATCH,
                     unet_batch=UNET_BATCH, device="cuda", info=info)
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()

    f565s, f352s = preprocess(raws, BASE_SIZE, CLIP_SIZE)
    pad = lambda a: np.concatenate([a, np.zeros((CLIP_BATCH - len(a),) + a.shape[1:],  # noqa: E731
                                                a.dtype)])
    clip_in = [pad(np.repeat(np.stack(f352s), 2, axis=0)),
               pad(np.tile(cond.float().cpu().numpy(), (len(raws), 1)))]
    unet_dtype = next(unet.parameters()).dtype
    unet_in = [torch.from_numpy(b).cuda().to(unet_dtype)
               for _, b in bucket_batches(f565s, UNET_BATCH)]
    check(len(seen["clip"]) == 1 and len(seen["unet"]) == len(unet_in) == 2,
          f"forwards {info}, {len(unet_in)} host batches")
    off = {"clip_rows": int((_bits(seen["clip"][0][0]).cpu()
                             != _bits(torch.from_numpy(clip_in[0]))).sum()),
           "prompt_rows": int((_bits(seen["clip"][0][1].float()).cpu()
                               != _bits(torch.from_numpy(clip_in[1]))).sum()),
           "unet_batches": sum(int((_bits(g[0]) != _bits(w)).sum())
                               for g, w in zip(seen["unet"], unet_in))}
    check(not any(off.values()), f"the uint8 wire differs from the float32 wire: {off}")

    # the reciprocal route, for the record: how far CUDA's x / 255.0 (a
    # Python number) is from the host's division
    x = torch.arange(256, dtype=torch.float32, device="cuda")
    recip_off = int((_bits(x / 255.0).cpu()
                     != _bits(torch.from_numpy(np.arange(256, dtype=np.float32) / 255.0))).sum())
    exact = all(torch.equal(_bits(device_normalize(torch.from_numpy(ramp(16, 16)).cuda(), m, s)).cpu(),
                            _bits(torch.from_numpy(normalize(ramp(16, 16), m, s))))
                for m, s in ((TP_MEAN, TP_STD), (IMAGENET_MEAN, IMAGENET_STD)))
    check(exact, "device_normalize differs from normalize on the 256 byte values")
    rec = {"phase": "fusion_wire", "frames": [list(r.shape[:2]) for r in raws],
           "unet_dtype": str(unet_dtype), "elements_off": off,
           "byte_values": [len(np.unique(u565s[0])), len(np.unique(u352s[1]))],
           "reciprocal_route_values_off": recip_off}
    emit(rec)
    return rec


def phase_clipseg_f32(dev) -> dict:
    """The CLIPSeg forward of ``cli/eval_clipseg.py`` and
    ``cli/predict_clipseg.py``, which run in float32 (TF32 off): rd64 over
    ViT-B/16 at batch 32 and 352 px, seeded weights.  Counts K6's launches
    around one forward (10: blocks 0..9), times it (CUDA events, median of 5)
    and profiles one with K6's share of the device time."""
    clipseg = CLIPDensePredT(clip_cfg=VIT_B16, reduce_dim=64, extract_layers=(3, 6, 9))
    init_weights(clipseg, torch.Generator().manual_seed(SEED))
    clipseg = clipseg.to("cuda").eval()
    cond = clipseg.compute_conditional(prompt_tokens().cuda())
    gen = torch.Generator().manual_seed(SEED + 2)
    x = torch.randn(CLIP_BATCH, CLIP_SIZE, CLIP_SIZE, 3, generator=gen).cuda()
    conds = cond.repeat(CLIP_BATCH // 2, 1)
    torch.cuda.synchronize()
    reset_launch_counts()
    (logits,) = clipseg(x, conds)
    torch.cuda.synchronize()
    launches = launch_counts()
    check(tuple(logits.shape) == (CLIP_BATCH, CLIP_SIZE, CLIP_SIZE, 1)
          and logits.dtype == torch.float32 and bool(torch.isfinite(logits).all()),
          f"float32 CLIPSeg logits {tuple(logits.shape)} {logits.dtype} not finite")
    check(launches == PER_CLIPSEG_FORWARD,
          f"float32 CLIPSeg launches {launches} != {PER_CLIPSEG_FORWARD}")
    ms = time_ms(lambda: clipseg(x, conds), reps=5, warm=1)
    prof = phase_profile("clipseg_f32_profile", lambda: clipseg(x, conds),
                         "clipseg_f32_profile.txt", {"csa_attention": "csa_ffma_kernel"})
    rec = {"phase": "clipseg_f32", "dtype": "float32", "tf32": False,
           "clip_size": CLIP_SIZE, "clip_batch": CLIP_BATCH, "launches": launches,
           "ms_per_batch": ms, "img_per_s": CLIP_BATCH / ms * 1e3,
           "k6_device_ms": prof["by_kernel_ms"]["csa_attention"],
           "k6_device_share": prof["by_kernel_ms"]["csa_attention"] / prof["device_ms"],
           "card": dev["nvidia_smi"]}
    emit(rec)
    del clipseg, x, logits
    torch.cuda.empty_cache()
    return launches


def phase_card_vs_cpu() -> None:
    """The same float32 weights and inputs on the card (kernels) and on the
    CPU (plain versions): the two UNets of the fusion CLIs at 128x128 on the
    default route; EGM-UNet on the three other routes and the vanilla UNet at
    base_c 64 (mid widths up to 512: the pair kernel's 8x8 tile in float32) on
    the pair / fused-upsample route, each at 128x128 and at 100x132, where the
    decoder stages are not twice their inputs and ``Up`` pads; and a small
    CLIPSeg with 64-wide heads."""
    imgs = []
    for i in range(2):
        img, _ = synthetic_tp_sample(10 + i, 160, 128)
        imgs.append(normalize(resize_short_side(img, None, 128)[0]))
    x = torch.from_numpy(np.stack(imgs)[:, :128, :128].copy())  # 2 x 128 x 128 x 3
    x_odd = torch.from_numpy(np.stack(
        [normalize(synthetic_tp_sample(20 + i, 100, 132)[0]) for i in range(2)]))
    egm = in_float32(PER_FORWARD)
    cases = [("egm_unet", BASE_C, "gemm", "matmul", x, egm),
             ("grfb_unet", BASE_C, "gemm", "matmul", x, None)]
    for xx in (x, x_odd):
        cases += [
            ("egm_unet", BASE_C, "pair", "matmul", xx, per_forward(
                mca_fused=4, mca_gates=4, eafe_edge=8, conv3x3_gemm=12,
                conv3x3_pair_gemm=5)),
            # K2 for both decoder convs, where the default route has K5
            ("egm_unet", BASE_C, "gemm", "fused", xx, per_forward(
                mca_fused=4, mca_gates=4, eafe_edge=8, conv3x3_gemm=22,
                upsample2x_fused=4)),
            ("egm_unet", BASE_C, "pair", "fused", xx, in_float32(PER_FORWARD_PAIR)),
            ("unet", 64, "pair", "fused", xx, per_forward(
                conv3x3_pair_gemm=9, upsample2x_fused=4))]
    for name, base_c, conv_impl, up_impl, xx, want in cases:
        model = create_model(name, base_c=base_c, num_classes=2, conv_impl=conv_impl,
                             upsample_impl=up_impl,
                             generator=torch.Generator().manual_seed(SEED)).eval()
        cpu = model(xx)["out"]
        gpu_model = model.to("cuda")
        reset_launch_counts()
        gpu = gpu_model(xx.to("cuda"))["out"].cpu()
        launches = launch_counts()
        if want is not None:
            check(launches == want, f"{name} {conv_impl}/{up_impl} float32 forward "
                                    f"launches {launches} != {want}")
        else:  # no MCA, no EAFE; the GRFB blocks hold no plain 3x3 conv of their own
            check(launches["conv3x3_gemm"] >= 14 and launches["up_concat_conv"] == 4
                  and launches["mca_fused"] == launches["mca_gates"] == 0
                  and launches["eafe_edge"] == 0,
                  f"grfb_unet launches {launches}")
        card_vs_cpu_record(name, list(xx.shape), gpu, cpu, launches, masks=True,
                           base_c=base_c, route=[conv_impl, up_impl])

    cfg = CLIPConfig(embed_dim=64, image_resolution=64, vision_layers=3,
                     vision_width=128, vision_patch_size=16, context_length=32,
                     vocab_size=512, transformer_width=64, transformer_heads=1,
                     transformer_layers=2, long_clip=True)
    seg = CLIPDensePredT(clip_cfg=cfg, reduce_dim=32, extract_layers=(1, 2))
    init_weights(seg, torch.Generator().manual_seed(SEED)).eval()
    gen = torch.Generator().manual_seed(SEED + 3)
    img = torch.randn(2, 96, 96, 3, generator=gen)  # a resampled 6x6 positional grid
    tok = torch.zeros((2, 32), dtype=torch.int64)
    tok[:, :5] = torch.randint(1, 500, (2, 5), generator=gen)
    tok[:, 5] = 511
    (cpu,) = seg(img, tok)
    seg = seg.to("cuda")
    reset_launch_counts()
    (gpu,) = seg(img.cuda(), tok.cuda())
    launches = launch_counts()
    check(launches["csa_attention"] == 3, f"small CLIPSeg launches {launches}")
    card_vs_cpu_record("clipseg_small", list(img.shape), gpu.cpu(), cpu, launches,
                       masks=False)


def card_vs_cpu_record(name, shape, gpu, cpu, launches, masks: bool, **extra) -> None:
    diff = (gpu - cpu).abs().max().item()
    scale = cpu.abs().max().item()
    tol = 1e-3 * max(scale, 1.0)
    rec = {"phase": "card_vs_cpu", "model": name, **extra, "shape": shape,
           "dtype": "float32",
           "logits_max_abs_diff": diff, "logits_max_abs": scale, "tol": tol,
           "launches": launches}
    if masks:
        rec["mask_agreement"] = (gpu.argmax(-1) == cpu.argmax(-1)).float().mean().item()
    emit(rec)
    check(bool(torch.isfinite(gpu).all()), f"{name}: card logits are not finite")
    check(diff <= tol, f"{name}: card vs CPU logits differ by {diff} > {tol}")
    if masks:
        check(rec["mask_agreement"] >= 0.99,
              f"{name}: card vs CPU mask agreement {rec['mask_agreement']} < 0.99")


# ------------------------------------------------------------ training

TRAIN_BATCH, TRAIN_CROP, TRAIN_LR = 8, 480, 0.02  # cli/train.py defaults
TRAIN_WARM, TRAIN_TIMED = 3, 10


def train_batches(n: int):
    """``n`` batches of the reference recipe's crops: synthetic 565x752
    samples through ``TrainTransform(crop_size=480)`` (seed 0), narrowed
    (uint8 masks) and on the card as float32; the train step casts them."""
    ds = SyntheticTPDataset(n=2 * TRAIN_BATCH, transforms=TrainTransform(
        crop_size=TRAIN_CROP, seed=SEED), cache=True)
    out = []
    for b in range(n):
        idx = [(b * TRAIN_BATCH + i) % len(ds) for i in range(TRAIN_BATCH)]
        images, targets = zip(*(ds[i] for i in idx))
        x, t = narrow_for_transfer(np.stack(images), np.stack(targets), torch.float32)
        out.append((x.cuda(), t.cuda()))
    return out


def train_state(base_c: int, remat=False, seed: int = SEED):
    model = create_model("egm_unet", num_classes=2, base_c=base_c, fold_bn=False,
                         remat=remat, generator=torch.Generator().manual_seed(seed))
    # the CLI's schedule for TP-928's 876 training images at batch 8, 200 epochs
    sched = warmup_poly_schedule(TRAIN_LR, 876 // TRAIN_BATCH, 200)
    return create_train_state(model.cuda(), sched)


def train_config(name: str, dtype, remat, batches, dev) -> dict:
    """3 warm-up and 10 timed steps of one configuration from the same
    weights: ms per step (CUDA events around each step, median), img/s, peak
    memory, the loss of every step; checks that the losses are finite, that
    parameters and running statistics moved, and that no hand-written kernel
    was launched."""
    state = train_state(BASE_C, remat)
    step = make_train_step(input_dtype=dtype)
    before = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, times = [], []
    for i in range(TRAIN_WARM + TRAIN_TIMED):
        x, t = batches[i % len(batches)]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, aux = step(state, x, t)
        end.record()
        losses.append(aux["loss"])
        if i >= TRAIN_WARM:
            end.synchronize()
            times.append(start.elapsed_time(end))
    torch.cuda.synchronize()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [v.item() for v in losses]
    after = state.model.state_dict()
    still = [k for k in after if torch.equal(before[k], after[k])]
    total = {kind: sum(1 for k in after if k.endswith((".mean", ".var")) == (kind == "stats"))
             for kind in ("params", "stats")}
    moved = {kind: total[kind] - sum(1 for k in still if k.endswith((".mean", ".var"))
                                     == (kind == "stats")) for kind in total}
    ms = statistics.median(times)
    rec = {"phase": "train", "config": name, "model": "egm_unet", "base_c": BASE_C,
           "batch": TRAIN_BATCH, "crop": TRAIN_CROP, "dtype": str(dtype).split(".")[1],
           "remat": remat, "tf32": False, "steps_warm": TRAIN_WARM,
           "steps_timed": TRAIN_TIMED, "ms_per_step": ms, "ms_per_step_runs": times,
           "img_per_s": TRAIN_BATCH / ms * 1e3, "peak_mem_bytes": peak,
           "peak_mem_gib": peak / 2 ** 30, "losses": losses, "lr_last": aux["lr"],
           "moved": moved, "leaves": total, "unmoved": still, "launches": launches,
           "card": dev["nvidia_smi"]}
    emit(rec)
    check(all(np.isfinite(losses)), f"train {name}: losses not finite {losses}")
    # every running statistic; the parameters as a whole (a leaf with a tiny
    # gradient can stay put under the warm-up's small first rates)
    check(moved["stats"] == total["stats"] and moved["params"] >= 0.9 * total["params"],
          f"train {name}: moved {moved} of {total}; still {still}")
    check(not any(launches.values()), f"train {name}: kernels launched {launches}")
    return rec, state, step


def phase_train(dev) -> dict:
    """The training path at full width: egm_unet (A+B+C), base_c 32, 2
    classes, SGD at the recipe's 0.02 (warm-up and poly schedule), batch 8,
    480x480 crops; bf16, float32, bf16 with stage remat; then one bf16 step
    under the profiler."""
    batches = train_batches(4)
    launches = {k: 0 for k in SOURCES}
    for name, dtype, remat in (("bf16", torch.bfloat16, False),
                               ("float32", torch.float32, False),
                               ("bf16_remat_stage", torch.bfloat16, "stage")):
        rec, state, step = train_config(name, dtype, remat, batches, dev)
        launches = {k: v + rec["launches"][k] for k, v in launches.items()}
        if name == "bf16":
            x, t = batches[0]
            reset_launch_counts()
            phase_profile("train_profile", lambda: step(state, x, t),
                          "train_profile.txt", {})
            check(not any(launch_counts().values()), "profiled train step launched a kernel")
        del state, step
        torch.cuda.empty_cache()
    return launches


def phase_train_cli(dev) -> tuple:
    """``cli/train.py`` as a user runs it on the card: 2 epochs of 32
    synthetic 480x480 crops at batch 8 in bf16, eval at 565; ``--resume``
    for a third epoch; then the best checkpoint served folded on the kernels
    by ``Predictor.from_checkpoint``, its masks held against the unfolded
    graph in eval mode on the same 4 images."""
    logs = OUT_DIR / "train_cli"
    if logs.exists():
        shutil.rmtree(logs)
    logs.mkdir(parents=True)
    # checkpoints (about 18 MB an epoch) go to a temporary directory; the
    # logs and results files to chiprun_out/train_cli
    tmp = tempfile.TemporaryDirectory(prefix="egm_train_cli_")
    out = Path(tmp.name)
    common = ["--synthetic", "--synthetic-size", str(TRAIN_CROP), "--synthetic-n", "32",
              "--synthetic-val-n", "4", "--batch-size", str(TRAIN_BATCH), "--amp",
              "--eval-size", "565", "--print-freq", "2"]
    runs = {}
    reset_launch_counts()
    for tag, extra in (("first", ["--epochs", "2", "--save-dir", str(out / "save"),
                                  "--results-file", str(logs / "results.txt")]),
                       ("resume", ["--epochs", "3", "--resume", str(out / "save"),
                                   "--save-dir", str(out / "save2"),
                                   "--results-file", str(logs / "results2.txt")])):
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            train_cli.main(common + extra)
        torch.cuda.synchronize()
        runs[tag] = (printed.getvalue(), time.perf_counter() - t0)
        (logs / f"{tag}.log").write_text(printed.getvalue())
    train_launches = launch_counts()
    check(not any(train_launches.values()), f"train CLI launched kernels {train_launches}")
    first, resumed = runs["first"][0], runs["resume"][0]
    check(first.count("dice coefficient: ") == 2 and resumed.count("dice coefficient: ") == 1,
          "train CLI: dice lines per epoch")
    blocks = (logs / "results.txt").read_text().count("[epoch: ")
    check(blocks == 2, f"results.txt holds {blocks} epoch blocks")
    check("resumed from epoch 1" in resumed, "train CLI did not resume from epoch 1")
    steps = 32 // TRAIN_BATCH
    payload = load_payload(str(out / "save2"))
    check(payload["epoch"] == 2 and payload["state"]["step"] == 3 * steps,
          f"resumed run ended at epoch {payload['epoch']}, step {payload['state']['step']}")
    sched = warmup_poly_schedule(TRAIN_LR, steps, 3)
    lr_first = re.search(r"Epoch: \[2\] \[0\].*?lr: (\d+\.\d{4})", resumed).group(1)
    check(lr_first == f"{sched(2 * steps + 1):.4f}",
          f"resumed lr {lr_first} != schedule({2 * steps + 1}) {sched(2 * steps + 1):.4f}")
    dice = [float(v) for v in re.findall(r"dice coefficient: (\d\.\d+)", first + resumed)]

    # serve the best checkpoint folded, on the kernels
    save = str(out / "save")
    epoch = best_epoch(save)
    images = [synthetic_tp_sample(300 + i)[0] for i in range(4)]
    train_graph = create_model("egm_unet", base_c=BASE_C, fold_bn=False)
    train_graph.load_state_dict(load_payload(save, epoch)["state"]["model"])
    train_graph = train_graph.cuda().eval()
    agreement, serve_launches = {}, {}
    for dt in ("float32", "bfloat16"):
        cfg = PredictorConfig(model_name="egm_unet", base_c=BASE_C, num_classes=2,
                              batch_size=4, dtype=dt)
        pred = Predictor.from_checkpoint(save, cfg, device="cuda")
        batch = np.zeros((4, *BUCKET, 3), np.float32)
        for row, img in enumerate(images):
            p = pred.preprocess(img)
            batch[row, :p.shape[0], :p.shape[1]] = p
        x = torch.from_numpy(batch).cuda()
        reset_launch_counts()
        with torch.inference_mode():
            masks = pred.forward(x.to(pred.dtype))
            serve_launches[dt] = launch_counts()
            ref = train_graph(x)["out"].argmax(dim=-1)
        agreement[dt] = (masks == ref).float().mean().item()
        want = PER_FORWARD if dt == "bfloat16" else in_float32(PER_FORWARD)
        check(serve_launches[dt] == want, f"from_checkpoint {dt} launches "
                                          f"{serve_launches[dt]} != {want}")
    rec = {"phase": "train_cli", "epochs": 3, "steps_per_epoch": steps,
           "batch": TRAIN_BATCH, "crop": TRAIN_CROP, "dtype": "bfloat16",
           "wall_s_first": runs["first"][1], "wall_s_resume": runs["resume"][1],
           "dice": dice, "best_epoch": epoch, "resumed_step": payload["state"]["step"],
           "lr_epoch2_first": lr_first, "launches_train": train_launches,
           "from_checkpoint_launches": serve_launches,
           "mask_agreement_folded_vs_unfolded": agreement, "card": dev["nvidia_smi"]}
    emit(rec)
    trained = folded_state_dict(save, "egm_unet", 2, BASE_C)  # for phase_quant
    tmp.cleanup()
    check(agreement["float32"] >= 0.99,
          f"folded float32 masks agree on {agreement['float32']} < 0.99 of pixels")
    return train_launches, serve_launches["bfloat16"], trained


def phase_train_card_vs_cpu() -> None:
    """One step of egm_unet (base_c 8, batch 2, 64x64) on the card and on the
    CPU from the same weights and batch.  float32 with TF32 off: loss and
    running statistics.  Gradients in float64 (``input_dtype=float64`` on
    float32 parameters, on both devices): in float32 the two devices'
    forwards part by about 1e-6, and there a max-pool or ReLU boundary
    moves (a 1e-5 relative change of the input moves the CPU's own float32
    gradients 124 times past the tolerance), so the float32 gradients are
    recorded, not held."""
    ds = SyntheticTPDataset(2, transforms=TrainTransform(crop_size=64, seed=SEED))
    images, targets = (torch.from_numpy(np.stack(a)) for a in zip(*(ds[i] for i in range(2))))
    images = images.float()
    out = {}
    for dev in ("cpu", "cuda"):
        for dt in (torch.float32, torch.float64):
            model = create_model("egm_unet", base_c=8, fold_bn=False,
                                 generator=torch.Generator().manual_seed(SEED)).to(dev)
            state = create_train_state(model, warmup_poly_schedule(TRAIN_LR, 10, 2))
            state, aux = make_train_step(input_dtype=dt)(state, images.to(dev),
                                                         targets.to(dev))
            out[dev, dt] = {"loss": aux["loss"].item(),
                            "grads": {k: p.grad.detach().cpu().clone()
                                      for k, p in model.named_parameters()},
                            "stats": {k: v.detach().cpu().clone()
                                      for k, v in model.named_buffers()}}

    def grad_ratio(dt):
        worst = (0.0, "")
        for k, g in out["cpu", dt]["grads"].items():
            tol = 1e-3 * g.abs().max().item() + 1e-6
            worst = max(worst, ((out["cuda", dt]["grads"][k] - g).abs().max().item() / tol, k))
        return worst

    f32, f64 = torch.float32, torch.float64
    stats_err = max(((out["cuda", f32]["stats"][k] - v).abs()
                     / (1e-4 + 1e-4 * v.abs())).max().item()
                    for k, v in out["cpu", f32]["stats"].items())
    loss_rel = abs(out["cuda", f32]["loss"] - out["cpu", f32]["loss"]) / abs(out["cpu", f32]["loss"])
    g64, g32 = grad_ratio(f64), grad_ratio(f32)
    rec = {"phase": "train_card_vs_cpu", "model": "egm_unet", "base_c": 8, "batch": 2,
           "crop": 64, "tf32": False, "loss_cpu": out["cpu", f32]["loss"],
           "loss_card": out["cuda", f32]["loss"], "loss_rel_diff": loss_rel,
           "stats_worst_over_tol": stats_err, "grads64_worst_over_tol": g64[0],
           "grads64_worst_leaf": g64[1], "grads32_worst_over_tol": g32[0],
           "grads32_worst_leaf": g32[1], "leaves": len(out["cpu", f32]["grads"])}
    emit(rec)
    check(loss_rel <= 1e-5, f"train card vs CPU: loss differs by {loss_rel} relative")
    check(stats_err <= 1.0, f"train card vs CPU: running statistics {stats_err} x tol")
    check(g64[0] <= 1.0, f"train card vs CPU: float64 gradient {g64[1]} at {g64[0]} x tol")


def phase_guard() -> None:
    """On the card each of K1..K5 and K7..K9 raises, and launches nothing,
    when asked to run inside an autograd graph."""
    gen = torch.Generator().manual_seed(SEED)
    t = lambda *s: torch.randn(*s, generator=gen).cuda()
    x, x1 = t(2, 16, 16, 32), t(2, 8, 8, 32)
    calls = {
        "mca_fused": lambda g: mca.mca_fused(x.requires_grad_(g), t(2, 16).sigmoid(),
                                             t(2, 16).sigmoid(), t(2, 32).sigmoid()),
        "mca_gates": lambda g: gates.mca_gates(
            x, [(t(2).requires_grad_(g), t(3)), (t(2), t(3)), (t(2), t(3))]),
        "conv3x3_gemm": lambda g: conv3x3.conv3x3_gemm(x, t(3, 3, 32, 32).requires_grad_(g),
                                                       t(32)),
        "conv3x3_pair_gemm": lambda g: conv3x3.conv3x3_pair_gemm(
            x, t(3, 3, 32, 32).requires_grad_(g), t(32), t(3, 3, 32, 32), t(32)),
        "upsample2x_fused": lambda g: resize2x.upsample2x_fused(x1.requires_grad_(g)),
        "eafe_edge": lambda g: edge.eafe_edge(x1.requires_grad_(g)),
        "conv1x1_gemm": lambda g: conv1x1.conv1x1_gemm(
            x.bfloat16(), t(1, 1, 32, 16).requires_grad_(g), t(16), relu=True),
        "up_concat_conv": lambda g: upconv.up_concat_conv(
            x, x1, t(3, 3, 64, 32), t(32).requires_grad_(g))}
    raised = {}
    with torch.enable_grad():
        for name, call in calls.items():
            reset_launch_counts()
            try:
                call(True)
                raised[name] = False
            except RuntimeError as e:
                raised[name] = "forward-only kernel" in str(e)
            check(launch_counts()[name] == 0, f"{name} launched inside autograd")
            call(False)
            check(launch_counts()[name] == 1, f"{name} did not launch without grad")
    torch.cuda.synchronize()
    emit({"phase": "autograd_guard", "raised": raised})
    check(all(raised.values()), f"kernel wrappers did not refuse autograd: {raised}")


# ------------------------------------------------ GPU-resident training set

CACHE_N = 876  # TP-928's training split
CACHE_SRC = source_size(TRAIN_CROP)  # 960: the canvas of 480 crops
CACHE_TIMED = 30


def aug_sources(n: int, first: int):
    """uint8 canvases of ``n`` synthetic 565x752 samples, as the cache holds
    them."""
    srcs = [source_canvas(*synthetic_tp_sample(first + i), CACHE_SRC) for i in range(n)]
    return (torch.from_numpy(np.stack([s[0] for s in srcs])),
            torch.from_numpy(np.stack([s[1] for s in srcs])))


def phase_device_aug_card_vs_cpu() -> None:
    """The augmentation of one batch (8 canvases of 960x960, 480 crops) with
    the same draws on the card and on the CPU: images within 1e-5 in the
    source's [0, 1] units (x std of the normalization), masks equal except
    where a source coordinate lies within 1e-4 of an integer (counted)."""
    imgs, masks = aug_sources(TRAIN_BATCH, 400)
    lo, hi = scale_range(CACHE_SRC)
    params = draw_params(torch.Generator().manual_seed(SEED), TRAIN_BATCH, CACHE_SRC,
                         TRAIN_CROP, lo, hi)
    cpu_i, cpu_m = augment_with_params(to_unit(imgs), masks, params, TP_MEAN, TP_STD,
                                       TRAIN_CROP)
    gi, gm = imgs.cuda(), masks.cuda()
    gparams = {k: v.cuda() for k, v in params.items()}
    run = lambda: augment_with_params(to_unit(gi), gm, gparams, TP_MEAN, TP_STD, TRAIN_CROP)
    card_i, card_m = run()
    ms = time_ms(run, reps=10, warm=2)
    std = torch.from_numpy(TP_STD)
    err_norm = (card_i.cpu() - cpu_i).abs().max().item()
    err_src = ((card_i.cpu() - cpu_i).abs() * std).max().item()
    ys, xs = source_coords(params, CACHE_SRC, TRAIN_CROP)
    near = (((ys - ys.round()).abs() < 1e-4)[:, :, None]
            | ((xs - xs.round()).abs() < 1e-4)[:, None, :])
    diff = card_m.cpu() != cpu_m
    rec = {"phase": "device_aug_card_vs_cpu", "batch": TRAIN_BATCH, "src": CACHE_SRC,
           "crop": TRAIN_CROP, "sizes": params["sizes"].tolist(),
           "max_abs_err_normalized": err_norm, "max_abs_err_source_units": err_src,
           "mask_diff_pixels": int(diff.sum()), "near_integer_pixels": int(near.sum()),
           "mask_diff_off_near_integer": int((diff & ~near).sum()),
           "aug_ms_per_batch": ms}
    emit(rec)
    check(err_src <= 1e-5, f"device_aug card vs CPU: images differ by {err_src} > 1e-5")
    check(not (diff & ~near).any(), f"device_aug card vs CPU: {rec['mask_diff_off_near_integer']} "
                                    "mask pixels differ away from integer coordinates")


def h2d_copies(fn) -> tuple:
    """Host-to-device copies that ``fn`` makes, by torch.profiler: their
    count, and the outermost operator of each (count by name)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    count = sum(e.count for e in prof.key_averages() if "Memcpy HtoD" in e.key)
    owners = {}
    for e in prof.events():
        n = sum(1 for k in getattr(e, "kernels", []) if "Memcpy HtoD" in k.name)
        if n:
            top = e
            while top.cpu_parent is not None:
                top = top.cpu_parent
            owners[top.name] = owners.get(top.name, 0) + n
    return count, owners


def loop_ms(batches, step, state, n: int) -> tuple:
    """Host-clock ms per step of ``n`` steps over the iterator ``batches``
    (synchronized at both ends), and the state."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x, t = next(batches)
        state, aux = step(state, x, t)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n, state, aux


def phase_train_device_cache(dev) -> dict:
    """The reference's data scale on the card: 876 synthetic 565x752 images
    cached as 960x960 canvases (about 3.2 GB), egm_unet base_c 32 trained in
    bf16 at batch 8 on 480 crops for one whole epoch from the cache (109
    steps, CUDA events around each batch + step), then 30 steps from the
    host loader (threads, PIL transforms, pinned copies one batch ahead)
    from the same weights.  Host-to-device copies of 5 batches and of 5
    batches + steps counted by the profiler (by outermost operator): the
    index vector must be the only one."""
    ds = SyntheticTPDataset(n=CACHE_N)
    lo, hi = scale_range(CACHE_SRC)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    cache = DeviceDatasetCache(ds, CACHE_SRC, TP_MEAN, TP_STD, TRAIN_CROP, lo, hi,
                               out_dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    mem_delta = torch.cuda.memory_allocated() - mem0
    check(cache.hbm_bytes == CACHE_N * CACHE_SRC * CACHE_SRC * 4 and mem_delta >= cache.hbm_bytes,
          f"cache holds {cache.hbm_bytes} B, allocated {mem_delta} B")

    state = train_state(BASE_C)
    step = make_train_step(input_dtype=torch.bfloat16)
    gen = epoch_generator(SEED, 0, "cuda")
    epoch = cache.epoch_iter(gen, TRAIN_BATCH, np.random.default_rng(SEED))
    reset_launch_counts()
    h2d0 = cache.h2d_bytes
    times, losses, steps = [], [], 0
    worst = torch.zeros((), dtype=torch.uint8, device=cache.imgs.device)
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        batch = next(epoch, None)
        if batch is None:
            break
        x, t = batch
        check(x.shape == (TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP, 3) and x.dtype == torch.bfloat16,
              f"cache batch {tuple(x.shape)} {x.dtype}")
        worst = torch.maximum(worst, t.amax())
        state, aux = step(state, x, t)
        end.record()
        losses.append(aux["loss"])
        steps += 1
        if steps > TRAIN_WARM:
            end.synchronize()
            times.append(start.elapsed_time(end))
    torch.cuda.synchronize()
    launches = launch_counts()
    h2d_per_step = (cache.h2d_bytes - h2d0) / steps
    losses = [v.item() for v in losses]
    check(steps == CACHE_N // TRAIN_BATCH == 109, f"{steps} steps in an epoch of the cache")
    check(worst.item() <= 1, f"a cache batch holds mask value {worst.item()} (a sentinel row?)")
    check(all(np.isfinite(losses)), "device-cache losses are not finite")
    check(not any(launches.values()), f"device-cache training launched kernels {launches}")
    # one more epoch: copies per batch and per batch + step, by the profiler
    more = cache.epoch_iter(epoch_generator(SEED, 1, "cuda"), TRAIN_BATCH,
                            np.random.default_rng(SEED + 1))
    copies_batch, owners_batch = h2d_copies(lambda: [next(more) for _ in range(5)])
    copies_step, owners_step = h2d_copies(lambda: loop_ms(more, step, state, 5))
    copies_batch, copies_step = copies_batch / 5, copies_step / 5
    ms_cache_loop, state, _ = loop_ms(more, step, state, CACHE_TIMED)
    del state, more, epoch

    # the host loader on the same steps, from the same weights
    host_ds = SyntheticTPDataset(n=CACHE_N, transforms=TrainTransform(
        crop_size=TRAIN_CROP, seed=SEED))
    loader = BatchLoader(host_ds, TRAIN_BATCH, shuffle=True, seed=SEED)
    prepare = lambda b: to_device(narrow_for_transfer(b[0], b[1], torch.bfloat16), "cuda")
    host_iter = iter(DevicePrefetcher(loader, prepare))
    hstate = train_state(BASE_C)
    _, hstate, _ = loop_ms(host_iter, step, hstate, TRAIN_WARM)
    ms_host_loop, hstate, haux = loop_ms(host_iter, step, hstate, CACHE_TIMED)
    loader.close()
    host_bytes = TRAIN_BATCH * TRAIN_CROP * TRAIN_CROP * (3 * 2 + 1)
    del hstate, cache
    ms = statistics.median(times)
    rec = {"phase": "train_device_cache", "model": "egm_unet", "base_c": BASE_C,
           "images": CACHE_N, "image_hw": [565, 752], "src": CACHE_SRC,
           "crop": TRAIN_CROP, "batch": TRAIN_BATCH, "dtype": "bfloat16",
           "cache_build_s": build_s, "hbm_bytes": CACHE_N * CACHE_SRC * CACHE_SRC * 4,
           "memory_allocated_delta": mem_delta, "steps_per_epoch": steps,
           "steps_timed": len(times), "ms_per_step": ms, "ms_per_step_runs": times,
           "img_per_s": TRAIN_BATCH / ms * 1e3, "h2d_bytes_per_step": h2d_per_step,
           "h2d_copies_per_batch": copies_batch, "h2d_copies_per_step": copies_step,
           "h2d_owners_5_batches": owners_batch, "h2d_owners_5_steps": owners_step,
           "ms_per_step_loop_cache": ms_cache_loop, "ms_per_step_loop_host_loader": ms_host_loop,
           "img_per_s_host_loader": TRAIN_BATCH / ms_host_loop * 1e3,
           "h2d_bytes_per_step_host_loader": host_bytes, "mask_max": worst.item(),
           "losses_first_last": [losses[0], losses[-1]], "launches": launches,
           "card": dev["nvidia_smi"]}
    emit(rec)
    # the profiler can miss a copy at the start of its window, never add one
    check(h2d_per_step == TRAIN_BATCH * 8 and copies_batch <= 1 and copies_step <= 1,
          f"host-to-device traffic per step: {h2d_per_step} B, {copies_batch} copies per "
          f"batch, {copies_step} per step (want the one index vector)")
    return launches


# ------------------------------------------------------------ int8 serving

# the hand-written kernels each mode's profile must show
QUANT_PROFILE_KERNELS = {"int8df": {"conv3x3_gemm": "conv3x3_mma_kernel",
                                    "up_concat_conv": "upconv_mma_kernel"},
                         "int8": {"mca_fused": "mca_tile_kernel"}, "int8full": {}}


def quant_predictor(mode, state=None):
    """The serving predictor (egm_unet base_c 32, bf16, batch 8) with int8
    ``mode`` (None: bf16), random weights of seed 0 or ``state``."""
    cfg = PredictorConfig(model_name="egm_unet", base_c=BASE_C, num_classes=2,
                          batch_size=BATCH, dtype="bfloat16", quant=mode)
    pred = Predictor(config=cfg, device="cuda", generator=torch.Generator().manual_seed(SEED))
    if state is not None:
        pred.model.load_state_dict(state)
    return pred


def phase_quant(dev, trained) -> dict:
    """The serving bucket (batch 8, 576x768) in bf16 and under int8df, int8
    and int8full, on random weights and on ``train_cli``'s checkpoint: the
    calibration seconds, ms per batch (CUDA events, median of 5; bf16 before
    and after), kernel launches of one forward, masks against bf16, and one
    profiled forward per mode on the trained weights
    (``chiprun_out/quant_profile_<mode>.txt``).  int8df must agree with
    bf16 on >= 99% of the trained checkpoint's pixels."""
    images = [synthetic_tp_sample(500 + i)[0] for i in range(BATCH)]
    total = {k: 0 for k in SOURCES}
    out = {}
    for weights, state in (("random", None), ("trained", trained)):
        base = quant_predictor(None, state)
        x = bucket_batch(base, images)
        ref = base.forward(x)
        ms_bf16 = [time_ms(lambda: base.forward(x), reps=5, warm=1)]
        modes = {}
        for mode in QUANT_MODES:
            pred = quant_predictor(mode, state)
            torch.cuda.synchronize()
            reset_launch_counts()
            masks = pred.forward(x)  # calibrates on x, then one forward
            torch.cuda.synchronize()
            launches = {k: v - PER_CALIBRATION[k] for k, v in launch_counts().items()}
            check(launches == PER_FORWARD_QUANT[mode],
                  f"{mode} launches {launches} != {PER_FORWARD_QUANT[mode]} "
                  f"(calibration's {PER_CALIBRATION} taken off)")
            total = {k: v + launches[k] for k, v in total.items()}
            with pred.quantizer.active():
                logits = pred.model(x)["out"]
            check(tuple(logits.shape) == (BATCH, *BUCKET, 2) and bool(torch.isfinite(logits).all()),
                  f"{mode} logits not finite [8, 576, 768, 2]")
            modes[mode] = {"calibration_s": pred.calibration_s,
                           "scales": len(pred.quantizer.scales),
                           "sites": pred.quantizer.sites,
                           "ms_per_batch": time_ms(lambda: pred.forward(x), reps=5, warm=1),
                           "launches_per_forward": launches,
                           "mask_agreement_vs_bf16": (masks == ref).float().mean().item()}
            if weights == "trained":
                phase_profile(f"quant_profile_{mode}", lambda: pred.forward(x),
                              f"quant_profile_{mode}.txt", QUANT_PROFILE_KERNELS[mode])
            del pred, logits
        ms_bf16.append(time_ms(lambda: base.forward(x), reps=5, warm=1))
        out[weights] = {"ms_per_batch_bf16": statistics.median(ms_bf16),
                        "ms_per_batch_bf16_runs": ms_bf16, "modes": modes,
                        "foreground_share_bf16": ref.float().mean().item()}
        del base
        torch.cuda.empty_cache()
    rec = {"phase": "quant", "model": "egm_unet", "base_c": BASE_C, "batch": BATCH,
           "bucket": list(BUCKET), "dtype": "bfloat16", "ship_sites": SHIP_QSTORE_SITES,
           **out, "launches": total, "card": dev["nvidia_smi"]}
    emit(rec)
    agree = out["trained"]["modes"]["int8df"]["mask_agreement_vs_bf16"]
    check(agree >= 0.99, f"int8df masks agree with bf16 on {agree} < 0.99 of the "
                         "trained checkpoint's pixels")
    return total


def phase_serve_quant(dev) -> dict:
    """``cli/serve.py --quant int8df --init-random`` on 127.0.0.1: a burst of
    4 PNG requests from 4 client threads, every one answered; the launches
    of the forwards it ran and of the calibration forward before them."""
    args = serve_cli.parse_args([
        "--init-random", "--model", "egm_unet", "--base-c", str(BASE_C),
        "--num-classes", "1", "--batch-size", str(BATCH), "--dtype", "bfloat16",
        "--quant", "int8df", "--batch-window-ms", "50", "--host", "127.0.0.1",
        "--port", "0"])
    httpd, batcher = serve_cli.make_server(args)
    pred = batcher.predictor
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    images = [synthetic_tp_sample(600 + i)[0] for i in range(4)]
    bodies = []
    for img in images:
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        bodies.append(buf.getvalue())
    replies = [None] * len(images)

    def client(i):
        replies[i] = http_request(httpd.server_port, "POST", "/predict", bodies[i])

    forwards, hook = count_forwards(pred.model)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    clients = [threading.Thread(target=client, args=(i,)) for i in range(len(images))]
    for t in clients:
        t.start()
    for t in clients:
        t.join(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    hook.remove()
    status, body = http_request(httpd.server_port, "GET", "/stats")
    stats = json.loads(body) if status == 200 else None
    httpd.shutdown()
    batcher.shutdown()
    httpd.server_close()
    thread.join(timeout=10)
    check(not thread.is_alive(), "the int8df server thread did not stop")
    check(all(r is not None and r[0] == 200 for r in replies),
          f"int8df HTTP statuses {[None if r is None else r[0] for r in replies]}")
    masks = [np.asarray(Image.open(io.BytesIO(r[1]))) for r in replies]
    for img, mask in zip(images, masks):
        check(mask.shape == img.shape[:2] and set(np.unique(mask)) <= {0, 255},
              f"int8df reply {mask.shape} for request {img.shape}")
    # one calibration forward, then the serving forwards
    n_fwd = len(forwards) - 1
    expect = {k: v * n_fwd + PER_CALIBRATION[k] for k, v in PER_FORWARD_QUANT["int8df"].items()}
    check(n_fwd >= 1 and launches == expect,
          f"int8df serve launches {launches} != {expect} for {n_fwd} forwards")
    check(pred.quantizer.mode == "int8df" and pred.quantizer.sites == SHIP_QSTORE_SITES,
          f"server quantizer {pred.quantizer.mode} {pred.quantizer.sites}")
    rec = {"phase": "serve_quant", "quant": "int8df", "requests": len(images),
           "answered": len(masks), "forwards": n_fwd, "launches": launches,
           "calibration_s": pred.calibration_s, "wall_s": wall, "stats": stats,
           "card": dev["nvidia_smi"]}
    emit(rec)
    return launches


# ---------------------------------------------- the text branch's training

# cli/train_clipseg.py at the reference's configuration (ViT-B/16, rd64,
# extract (3, 6, 9), batch 64 at 352 px), 128 synthetic samples, 3 epochs:
# 2 steps an epoch; cli/train_longclip.py on a random ViT-B/16 tower (224 px,
# 248-token texts), batch 32, a fixed pool of 64 triples
SEG_BATCH, SEG_N, SEG_EPOCHS = 64, 128, 3
LONGCLIP_BATCH, LONGCLIP_POOL, LONGCLIP_STEPS = 32, 64, 10
CSA_SEG_TRAIN_SHAPE = (SEG_BATCH, (CLIP_SIZE // 16) ** 2 + 1, 768, 12)
CSA_LONGCLIP_SHAPE = (LONGCLIP_BATCH, (224 // 16) ** 2 + 1, 768, 12)
# K6 launches: 10 per CLIPSeg step and probe (tower blocks 0..9, under
# no_grad); 1 per Long-CLIP step (encode_image's last block, forward; the
# backward is csa_backward, plain tensor code)
PER_CLIPSEG_TRAIN_FORWARD = per_forward(csa_attention=10)
PER_LONGCLIP_STEP = per_forward(csa_attention=1)


def timed_steps(module, maker: str, times: list) -> None:
    """Replace ``module.<maker>`` by one whose steps are bracketed by CUDA
    events (synchronized after each step); their times go to ``times``."""
    make = getattr(module, maker)

    def make_timed(*args, **kwargs):
        step = make(*args, **kwargs)

        def timed(*a):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(*a)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            return out
        return timed
    setattr(module, maker, make_timed)


def snapshot_at(module, creator: str, snap: dict, take) -> None:
    """Replace ``module.<creator>`` (a train-state factory) by one that puts
    ``take(model)`` in ``snap["before"]`` first: the weights as the CLI
    built them, before any step."""
    create = getattr(module, creator)

    def creating(model, **kwargs):
        snap["before"] = take(model)
        return create(model, **kwargs)
    setattr(module, creator, creating)


def text_kernel_records(records: list) -> None:
    """K6 in float32 at the two training paths' shapes, on the in_proj views
    (the CUDA-core kernel: the CLIs train in float32), with the bound and the
    two-SDPA yardstick; then the closed-form backward's time per call at
    Long-CLIP's shape, float32 and bf16, beside autograd through the plain
    version (forward and backward)."""
    for site, shape in (("train_clipseg: clip.visual.resblock0..9", CSA_SEG_TRAIN_SHAPE),
                        ("train_longclip: clip.visual.resblock11", CSA_LONGCLIP_SHAPE)):
        records.append(kernel_record(site, csa_call(shape, torch.float32, views=True), 5))
        check(records[-1]["variant"] == PATH_VARIANTS["csa_attention"]["float32"],
              f"K6 float32 at {shape}: variant {records[-1]['variant']}")
        torch.cuda.empty_cache()
    b, s_, d, h = CSA_LONGCLIP_SHAPE
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator().manual_seed(SEED + 5)
        q, k, v, g = [(torch.randn(b, s_, d, generator=gen) * sc).to(dtype).cuda()
                      for sc in (1.5, 1.0, 1.0, 1.0)]
        q, k, v = torch.cat([q, k, v], dim=-1).chunk(3, dim=-1)
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

        def plain_grads():
            with torch.enable_grad():
                return torch.autograd.grad(csa.csa_plain(*leaves, h), leaves, g)
        records.append({"phase": "csa_backward", "name": "csa_attention",
                        "shape": [b, s_, d], "heads": h, "dtype": str(dtype).split(".")[1],
                        "layout": "in_proj_views",
                        "ms": time_ms(lambda: csa.csa_backward(q, k, v, g, h), reps=10),
                        "plain_autograd_ms": time_ms(plain_grads, reps=5)})
        emit(records[-1])
    torch.cuda.empty_cache()


def phase_train_clipseg(dev) -> dict:
    """``cli/train_clipseg.py`` as a user runs it on the card, at the
    reference's width: ms per step by CUDA events, img/s, peak memory, K6's
    launches (10 per step, 10 per epoch's fgIoU probe), the loss of every
    step and the fgIoU of every epoch; fails unless the losses are finite,
    the tower is bit-identical before and after, the decoder moved and
    ``meta.json`` was written."""
    tmp = tempfile.TemporaryDirectory(prefix="egm_train_clipseg_")
    times, snap = [], {}
    timed_steps(train_clipseg_cli, "make_clipseg_train_step", times)
    snapshot_at(train_clipseg_cli, "create_clipseg_state", snap,
                lambda m: {k: t.detach().clone() for k, t in m.state_dict().items()})
    printed = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        run = train_clipseg_cli.main([
            "--synthetic", "--synthetic-n", str(SEG_N), "--epochs", str(SEG_EPOCHS),
            "--batch-size", str(SEG_BATCH), "--image-size", str(CLIP_SIZE),
            "--print-freq", "1", "--save-dir", str(Path(tmp.name) / "save")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    train_clipseg_cli.make_clipseg_train_step = make_clipseg_train_step
    train_clipseg_cli.create_clipseg_state = create_clipseg_state
    (OUT_DIR / "train_clipseg.log").write_text(printed.getvalue())
    steps = SEG_EPOCHS * (SEG_N // SEG_BATCH)
    after = run["state"].model.state_dict()
    tower_same = all(torch.equal(after[k], t) for k, t in snap["before"].items()
                     if k.startswith("clip."))
    decoder_moved = sum(not torch.equal(after[k], t) for k, t in snap["before"].items()
                        if not k.startswith("clip."))
    meta = (Path(run["save_dir"]) / "meta.json").is_file()
    ms = statistics.median(times[1:])
    want = {k: n * (steps + SEG_EPOCHS) for k, n in PER_CLIPSEG_TRAIN_FORWARD.items()}
    rec = {"phase": "train_clipseg", "model": "CLIPDensePredT(VIT_B16, rd64, extract 3/6/9)",
           "dtype": "float32", "tf32": False, "batch": SEG_BATCH, "image_size": CLIP_SIZE,
           "samples": SEG_N, "epochs": SEG_EPOCHS, "steps": len(times),
           "ms_per_step": ms, "ms_per_step_runs": times,
           "img_per_s": SEG_BATCH / ms * 1e3, "wall_s": wall, "peak_mem_bytes": peak,
           "peak_mem_gib": peak / 2 ** 30, "losses": run["losses"], "fgiou": run["fgiou"],
           "launches": launches, "launches_per_step_and_probe": 10,
           "tower_bit_identical": tower_same, "decoder_leaves_moved": decoder_moved,
           "meta_json": meta, "card": dev["nvidia_smi"]}
    emit(rec)
    # one more step of the trained state under the profiler, on a seeded batch
    gen = torch.Generator().manual_seed(SEED + 6)
    batch = (torch.randn(SEG_BATCH, CLIP_SIZE, CLIP_SIZE, 3, generator=gen).cuda(),
             (torch.rand(SEG_BATCH, CLIP_SIZE, CLIP_SIZE, generator=gen) < 0.3).float().cuda(),
             prompt_tokens((12,) * SEG_BATCH).cuda())
    step = make_clipseg_train_step()
    phase_profile("train_clipseg_profile", lambda: step(run["state"], *batch),
                  "train_clipseg_profile.txt", {"csa_attention": "csa_ffma_kernel"})
    del run, after, snap, batch
    tmp.cleanup()
    torch.cuda.empty_cache()
    check(len(times) == steps and len(rec["losses"]) == steps,
          f"train_clipseg: {len(times)} steps timed, {len(rec['losses'])} losses, not {steps}")
    check(all(np.isfinite(rec["losses"])), f"train_clipseg: losses {rec['losses']}")
    check(len(rec["fgiou"]) == SEG_EPOCHS, f"train_clipseg: fgIoU {rec['fgiou']}")
    check(tower_same, "train_clipseg: the frozen tower moved")
    check(decoder_moved > 0, "train_clipseg: no decoder leaf moved")
    check(meta, "train_clipseg: meta.json was not written")
    check(launches == want, f"train_clipseg launches {launches} != {want}")
    return launches


def phase_train_longclip(dev) -> dict:
    """``cli/train_longclip.py`` on a random ViT-B/16 Long-CLIP at full
    width: ms per step by CUDA events, img/s, peak memory, K6's launches (1
    per step: encode_image's last block, forward; the backward is the closed
    form), the loss of every step; fails unless the losses are finite,
    ``positional_embedding`` is bit-identical and ``logit_scale`` <= ln 100."""
    tmp = tempfile.TemporaryDirectory(prefix="egm_train_longclip_")
    times, snap = [], {}
    timed_steps(train_longclip_cli, "make_longclip_train_step", times)
    snapshot_at(train_longclip_cli, "create_longclip_state", snap,
                lambda m: m.positional_embedding.detach().clone())
    printed = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        run = train_longclip_cli.main([
            "--synthetic", "--synthetic-fixed", str(LONGCLIP_POOL),
            "--batch-size", str(LONGCLIP_BATCH), "--steps", str(LONGCLIP_STEPS),
            "--warmup-steps", "2", "--print-freq", "1",
            "--clip-weights", str(Path(tmp.name) / "none.pt"),
            "--save-dir", str(Path(tmp.name) / "save")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    train_longclip_cli.make_longclip_train_step = make_longclip_train_step
    train_longclip_cli.create_longclip_state = create_longclip_state
    (OUT_DIR / "train_longclip.log").write_text(printed.getvalue())
    model = run["state"].model
    pe_same = torch.equal(model.positional_embedding, snap["before"])
    scale = model.logit_scale.item()
    ms = statistics.median(times[1:])
    want = {k: n * LONGCLIP_STEPS for k, n in PER_LONGCLIP_STEP.items()}
    rec = {"phase": "train_longclip", "model": "CLIP(VIT_B16), random tower",
           "dtype": "float32", "tf32": False, "batch": LONGCLIP_BATCH,
           "image_size": VIT_B16.image_resolution, "context": VIT_B16.context_length,
           "pool": LONGCLIP_POOL, "steps": len(times), "warmup_steps": 2,
           "ms_per_step": ms, "ms_per_step_runs": times,
           "img_per_s": LONGCLIP_BATCH / ms * 1e3, "wall_s": wall, "peak_mem_bytes": peak,
           "peak_mem_gib": peak / 2 ** 30, "losses": run["losses"], "logit_scale": scale,
           "positional_embedding_bit_identical": pe_same, "launches": launches,
           "card": dev["nvidia_smi"]}
    emit(rec)
    gen = torch.Generator().manual_seed(SEED + 6)
    res, ctx = VIT_B16.image_resolution, VIT_B16.context_length
    batch = (torch.randn(LONGCLIP_BATCH, res, res, 3, generator=gen).cuda(),
             *(torch.randint(1, VIT_B16.vocab_size - 1, (LONGCLIP_BATCH, ctx),
                             generator=gen).cuda() for _ in range(2)))
    step = make_longclip_train_step()
    phase_profile("train_longclip_profile", lambda: step(run["state"], *batch),
                  "train_longclip_profile.txt", {"csa_attention": "csa_ffma_kernel"})
    del run, model, snap, batch
    tmp.cleanup()
    torch.cuda.empty_cache()
    check(len(times) == LONGCLIP_STEPS, f"train_longclip: {len(times)} steps timed")
    check(all(np.isfinite(rec["losses"])), f"train_longclip: losses {rec['losses']}")
    check(pe_same, "train_longclip: positional_embedding moved")
    check(scale <= MAX_LOGIT_SCALE, f"train_longclip: logit_scale {scale} > ln 100")
    check(launches == want, f"train_longclip launches {launches} != {want}")
    return launches


def leaf_ratio(card: dict, cpu: dict, rel: float) -> tuple:
    """The worst ``|card - cpu| / (rel * max|cpu leaf| + 1e-6)`` and its leaf."""
    worst = (0.0, "")
    for k, c in cpu.items():
        tol = rel * c.abs().max().item() + 1e-6
        worst = max(worst, ((card[k].cpu() - c).abs().max().item() / tol, k))
    return worst


def phase_text_train_card_vs_cpu() -> None:
    """One CLIPSeg step and one Long-CLIP step of the ``--tiny-clip``
    configurations from the same weights and batch on the card (K6) and on
    the CPU (its plain version), float32, TF32 off: the loss within 1e-5
    relative, the gradients within 1e-3 of each leaf's largest + 1e-6, the
    updated parameters within 1e-4 of each leaf's largest + 1e-6 at a rate
    of 1e-6.  At CLIPSeg's 1e-3 the updated parameters are recorded, not
    held: AdamW's first step moves each element by about the rate whatever
    its gradient's size, so an element whose gradient is within float32
    noise of zero (every attention's key bias: its exact gradient is 0) moves
    by +-lr on one device and -+lr on the other, 20x that tolerance, which a
    change of the CPU's thread count alone reproduces.  Then K6's closed-form
    backward on the card at Long-CLIP's shape against autograd through
    ``csa_plain`` on the card: float32 within 2e-4 of the largest gradient
    plus twice autograd's own distance from the float64 gradient (the closed
    form in float64), bf16 within one bf16 step of the largest."""
    gen = torch.Generator().manual_seed(SEED + 7)
    cfg = tiny_clip_config(64)
    seg_batch = (torch.randn(4, 64, 64, 3, generator=gen),
                 (torch.rand(4, 64, 64, generator=gen) < 0.3).float(),
                 torch.randint(1, cfg.vocab_size - 1, (4, cfg.context_length), generator=gen))
    seg_batch[2][:, 6:] = 0
    seg_batch[2][:, 6] = cfg.vocab_size - 1
    lc_cfg = tiny_clip_config(64)  # cli/train_longclip.py --tiny-clip
    lc_batch = (torch.randn(8, 64, 64, 3, generator=gen),
                torch.randint(1, lc_cfg.vocab_size - 1, (8, lc_cfg.context_length), generator=gen),
                torch.randint(1, lc_cfg.vocab_size - 1, (8, lc_cfg.context_length), generator=gen))

    def clipseg_step(device, lr):
        model = CLIPDensePredT(clip_cfg=cfg, reduce_dim=64, extract_layers=(0, 1))
        state = create_clipseg_state(init_weights(model, torch.Generator().manual_seed(SEED))
                                     .to(device), lr=lr)
        return make_clipseg_train_step()(state, *(t.to(device) for t in seg_batch))

    def longclip_step(device, lr):
        model = init_weights(CLIP(lc_cfg), torch.Generator().manual_seed(SEED)).to(device)
        state = create_longclip_state(model, lr=lr, warmup_steps=0, total_steps=10)
        return make_longclip_train_step()(state, *(t.to(device) for t in lc_batch))

    out = {}
    for name, step, lrs in (("clipseg", clipseg_step, (1e-6, 1e-3)),
                            ("longclip", longclip_step, (1e-6,))):
        for lr in lrs:
            res = {}
            for device in ("cpu", "cuda"):
                reset_launch_counts()
                state, aux = step(device, lr)
                res[device] = {
                    "loss": aux["loss"].item(), "launches": launch_counts()["csa_attention"],
                    "grads": {k: p.grad.detach().cpu() for k, p in
                              state.model.named_parameters() if p.grad is not None},
                    "params": {k: t.detach().cpu() for k, t in state.model.state_dict().items()}}
            cpu, card = res["cpu"], res["cuda"]
            g, p = leaf_ratio(card["grads"], cpu["grads"], 1e-3), \
                leaf_ratio(card["params"], cpu["params"], 1e-4)
            out[f"{name}_lr{lr:g}"] = {
                "loss_cpu": cpu["loss"], "loss_card": card["loss"],
                "loss_rel_diff": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
                "grads_worst_over_tol": g[0], "grads_worst_leaf": g[1],
                "params_worst_over_tol": p[0], "params_worst_leaf": p[1],
                "params_held": lr == 1e-6, "k6_launches_card": card["launches"],
                "k6_launches_cpu": cpu["launches"]}

    b, s_, d, h = CSA_LONGCLIP_SHAPE
    backward = {}
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator().manual_seed(SEED + 8)
        q, k, v, g = [(torch.randn(b, s_, d, generator=gen) * sc).to(dtype).cuda()
                      for sc in (1.5, 1.0, 1.0, 1.0)]
        q, k, v = torch.cat([q, k, v], dim=-1).chunk(3, dim=-1)
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        with torch.enable_grad():
            want = torch.autograd.grad(csa.csa_plain(*leaves, h), leaves, g)
        got = csa.csa_backward(q, k, v, g, h)
        exact = csa.csa_backward(q.double(), k.double(), v.double(), g.double(), h)
        worst = 0.0
        for a, r, e in zip(got, want, exact):
            r = r.double()
            tol = (2.0 ** -7 * r.abs().max().item() if dtype == torch.bfloat16
                   else 2e-4 * r.abs().max().item() + 2 * (r - e).abs().max().item())
            worst = max(worst, (a.double() - r).abs().max().item() / tol)
        backward[str(dtype).split(".")[1]] = worst
        check(all(bool(torch.isfinite(a).all()) for a in got), "csa_backward not finite")
        del q, k, v, g, leaves, want, got, exact
    torch.cuda.empty_cache()
    rec = {"phase": "text_train_card_vs_cpu", "tf32": False, "steps": out,
           "csa_backward_shape": list(CSA_LONGCLIP_SHAPE),
           "csa_backward_worst_over_tol": backward}
    emit(rec)
    for name, r in out.items():
        check(r["loss_rel_diff"] <= 1e-5, f"{name}: loss differs by {r['loss_rel_diff']}")
        check(r["grads_worst_over_tol"] <= 1.0,
              f"{name}: gradient {r['grads_worst_leaf']} at {r['grads_worst_over_tol']} x tol")
        check(not r["params_held"] or r["params_worst_over_tol"] <= 1.0,
              f"{name}: parameter {r['params_worst_leaf']} at {r['params_worst_over_tol']} x tol")
        check(r["k6_launches_card"] >= 1 and r["k6_launches_cpu"] == 0,
              f"{name}: K6 launches card {r['k6_launches_card']}, cpu {r['k6_launches_cpu']}")
    for dt, worst in backward.items():
        check(worst <= 1.0, f"csa_backward {dt}: {worst} x tol")


RN50 = CLIPConfig(embed_dim=1024, image_resolution=224, vision_layers=(3, 4, 6, 3),
                  vision_width=64, vision_patch_size=0, context_length=77,
                  transformer_width=512, transformer_heads=8, transformer_layers=12,
                  long_clip=False)


def phase_clip_resnet(dev) -> dict:
    """The ModifiedResNet tower: an RN50-width CLIP's ``encode_image`` at
    batch 32, 224 px, float32, in ms per batch (no hand-written kernel runs
    here: convs are cuDNN's, the attention pool plain attention); then a small
    RN CLIP's logits and image features on the card against the CPU within
    1e-3 of their range."""
    model = init_weights(CLIP(RN50), torch.Generator().manual_seed(SEED)).cuda().eval()
    gen = torch.Generator().manual_seed(SEED + 9)
    x = torch.randn(32, 224, 224, 3, generator=gen).cuda()
    reset_launch_counts()
    with torch.inference_mode():
        feats = model.encode_image(x)
        torch.cuda.synchronize()
        launches = launch_counts()
        ms = time_ms(lambda: model.encode_image(x), reps=10)
    check(tuple(feats.shape) == (32, 1024) and bool(torch.isfinite(feats).all()),
          f"RN50 features {tuple(feats.shape)} not finite [32, 1024]")
    del model, x, feats
    torch.cuda.empty_cache()

    small = CLIPConfig(embed_dim=32, image_resolution=64, vision_layers=(1, 2, 1, 1),
                       vision_width=16, vision_patch_size=0, context_length=16,
                       vocab_size=64, transformer_width=64, transformer_heads=1,
                       transformer_layers=1, long_clip=True)
    cpu_model = init_weights(CLIP(small), torch.Generator().manual_seed(SEED)).eval()
    with torch.no_grad():  # randomized BatchNorm statistics
        for name, p in cpu_model.named_parameters():
            if name.endswith(".mean"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
            elif name.endswith(".var"):
                p.copy_(torch.rand(p.shape, generator=gen) + 0.5)
    img = torch.randn(4, 64, 64, 3, generator=gen)
    tok = torch.randint(1, 60, (4, 16), generator=gen)
    tok[:, 9] = 63
    with torch.inference_mode():
        cpu_logits, _ = cpu_model(img, tok)
        cpu_feats = cpu_model.encode_image(img)
        card_model = cpu_model.cuda()
        card_logits, _ = card_model(img.cuda(), tok.cuda())
        card_feats = card_model.encode_image(img.cuda())
    diffs = {}
    for key, a, c in (("logits", card_logits, cpu_logits), ("image_features", card_feats,
                                                              cpu_feats)):
        scale = (c.max() - c.min()).item()
        diffs[key] = {"max_abs_diff": (a.cpu() - c).abs().max().item(), "range": scale,
                      "tol": 1e-3 * scale}
    rec = {"phase": "clip_resnet", "config": "RN50 widths: layers (3, 4, 6, 3), width 64, "
           "embed 1024, 224 px", "dtype": "float32", "tf32": False, "batch": 32,
           "encode_image_ms_per_batch": ms, "img_per_s": 32 / ms * 1e3, "launches": launches,
           "kernels": "none: cuDNN convs, eval BatchNorm, plain attention pool",
           "small_card_vs_cpu": diffs, "card": dev["nvidia_smi"]}
    emit(rec)
    check(not any(launches.values()), f"clip_resnet launched {launches}")
    for key, r in diffs.items():
        check(r["max_abs_diff"] <= r["tol"], f"clip_resnet {key}: card vs CPU {r}")
    return launches

# ------------------------------------------------------------ SegFormer

SEGFORMER_BATCH = 32
# the bf16 forward against the float32 one on the CPU at 2 x 256 x 320, as a
# share of the logits' norm: 0.0145 on an H100 (the bf16 program's error, level
# with the reference's own bf16 error in the cell); a broken route reads ~1
SEGFORMER_BF16_REL_RMS = 0.05
# K9 against the library route it would replace (cuDNN's conv, the bias add,
# the ReLU) at batch 32 of the 576x768 bucket: SegFormer-B5's head fuse (a
# folded 1x1 conv 3072 -> 768 with bias and ReLU), its per-stage Linears as
# 1x1 convs, and the fuse's map at narrower K, whose tiles keep wider slices
# of the weights resident (conv1x1_tile's BN from 16 to 128).
SEGFORMER_1X1 = [("linear_fuse", 144, 192, 3072, 768, True),
                 ("linear_c1", 144, 192, 64, 768, False),
                 ("linear_c2", 72, 96, 128, 768, False),
                 ("linear_c3", 36, 48, 320, 768, False),
                 ("linear_c4", 18, 24, 512, 768, False),
                 ("fuse_k2048", 144, 192, 2048, 768, True),
                 ("fuse_k1024", 144, 192, 1024, 768, True),
                 ("fuse_k512", 144, 192, 512, 768, True),
                 ("fuse_k256", 144, 192, 256, 768, True)]


def segformer_conv1x1_times() -> list:
    """K9 and the library route at ``SEGFORMER_1X1``, batch 32: the plain
    version's bits on exact operands, one bf16 step on seeded ReLU'd maps,
    and the device times that ``nn/layers.py::takes_conv1x1``'s rule is set
    from."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 26)
    rows = []
    for label, h, w, k, n, relu in SEGFORMER_1X1:
        key = (h, w, k, n, True, relu)
        xe, we, be = conv1x1_operands(SEGFORMER_BATCH, key, True, gen)
        check(bits_equal(conv1x1.conv1x1_gemm(xe, we, be, relu=relu),
                         conv1x1.conv1x1_plain(xe, we, be, relu=relu)),
              f"conv1x1_gemm {label}: exact operands, not the plain version's bits")
        del xe, we, be
        operands = conv1x1_operands(SEGFORMER_BATCH, key, False, gen)
        call = conv1x1_call(*operands, relu)
        err, tol, _ = compare(call[2], call[3], torch.bfloat16)
        check(err <= tol, f"conv1x1_gemm {label}: max abs err {err} > tol {tol}")
        r = {"site": label, "shape": [SEGFORMER_BATCH, h, w, k, n], "relu": relu,
             "tile": call[8]["tile"], "takes_conv1x1": takes_conv1x1(*operands),
             "device_ms": device_time_ms(call[2]), "library_device_ms": device_time_ms(call[4]),
             "bound_ms": bound(call[5], call[6], torch.bfloat16)[0], "max_abs_err": err,
             "tol": tol}
        r["k9_over_library"] = r["device_ms"] / r["library_device_ms"]
        rows.append(r)
        del call, operands
        torch.cuda.empty_cache()
    return rows


def phase_segformer(dev) -> dict:
    """SegFormer-B5 (``models/segformer.py``) served as ``cli/serve.py
    --model segformer_b5`` serves it: ``Predictor`` in bf16 on seeded weights,
    one bucket batch of 32 synthetic 565x752 frames; its logits, launches
    (``conv1x1_gemm`` among them), the 52 attention calls the program
    counts, ms per batch and a profile (``segformer_profile.txt``: the SDPA
    backend by kernel name); the same weights in float32 on the card and on
    the CPU at 2 x 256 x 320; and K9 against the library route at the head's
    1x1 shapes (``segformer_conv1x1_times``)."""
    rows = segformer_conv1x1_times()
    cfg = PredictorConfig(model_name="segformer_b5", num_classes=2,
                          batch_size=SEGFORMER_BATCH, dtype="bfloat16")
    pred = Predictor(config=cfg, device="cuda", generator=torch.Generator().manual_seed(SEED))
    frames = [synthetic_tp_sample(i, 565, 752)[0] for i in range(SEGFORMER_BATCH)]
    [(_, batch)] = bucket_batches([pred.preprocess(f) for f in frames], SEGFORMER_BATCH)
    x = torch.from_numpy(batch).to("cuda", pred.dtype)
    reset_launch_counts()
    reset_table()
    with recording():
        logits = pred.model(x)["out"]
        torch.cuda.synchronize()
    counters, launches = table(), launch_counts()
    calls = counters.get("segformer.attention_calls", {}).get("value")
    check(counters.get("segformer.forwards", {}).get("value") == 1 and calls == 52,
          f"SegFormer counters {counters}")
    # the head's 3072 -> 768 fuse is the one bf16 1x1 conv: conv1x1_suits declines it
    check(launches["conv1x1_gemm"] == 0, f"SegFormer took conv1x1_gemm: {launches}")
    check(tuple(logits.shape) == (SEGFORMER_BATCH, *BUCKET, 2)
          and bool(torch.isfinite(logits).all()), f"SegFormer logits {tuple(logits.shape)}")
    ms = time_ms(lambda: pred.forward(x), reps=5, warm=2)
    prof = phase_profile("segformer_profile", lambda: pred.forward(x), "segformer_profile.txt",
                         {"conv1x1_gemm": "conv1x1_gemm_kernel", "sdpa_flash": "flash",
                          "sdpa_efficient": "fmha", "sdpa_cudnn": "cudnn_generated"},
                         require=False)
    crop = x[:2, :256, :320].float().cpu()
    cpu_model = create_model("segformer_b5", generator=torch.Generator().manual_seed(SEED)).eval()
    cpu = cpu_model(crop)["out"]
    card_model = cpu_model.to("cuda")
    reset_launch_counts()
    gpu = card_model(crop.cuda())["out"].cpu()
    card_vs_cpu_record("segformer_b5", list(crop.shape), gpu, cpu, launch_counts(), masks=True)
    bf16 = pred.model(crop.cuda().bfloat16())["out"].float().cpu()
    rel_rms = float((bf16 - cpu).norm() / cpu.norm())
    check(rel_rms < SEGFORMER_BF16_REL_RMS,
          f"SegFormer bf16 on the card vs float32 on the CPU: rel rms {rel_rms}")
    rec = {"phase": "segformer", "batch": SEGFORMER_BATCH, "bucket": list(BUCKET),
           "dtype": "bfloat16", "launches": launches, "attention_calls": calls,
           "device_launches_per_forward": prof["launches"], "ms_per_batch": ms,
           "img_per_s": SEGFORMER_BATCH / ms * 1e3,
           "bf16_vs_cpu_f32_rel_rms": rel_rms,
           "conv1x1": rows, "card": dev["nvidia_smi"]}
    emit(rec)
    del pred, x, logits, card_model
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ data parallel

# two ranks share the card over gloo (NCCL takes one GPU a rank); the held
# checks run egm_unet at base_c 8, batch 4 (8 with --grad-accum 2), 64x64,
# float32, one step at 5e-4 without warm-up, as tests/test_torch_dp_train.py
DP_SMALL_BASE_C, DP_SMALL_SIZE, DP_SMALL_LR = 8, 64, 5e-4
DP_TIMED = 5  # full-width two-rank steps timed after TRAIN_WARM
DP_LONGCLIP_STEPS = 4


def dp_small_batch(batch: int) -> tuple:
    rng = np.random.default_rng(SEED + 9)
    images = rng.standard_normal((batch, DP_SMALL_SIZE, DP_SMALL_SIZE, 3)).astype(np.float32)
    targets = rng.integers(0, 2, (batch, DP_SMALL_SIZE, DP_SMALL_SIZE)).astype(np.int64)
    targets[rng.random(targets.shape) < 0.05] = 255
    return torch.from_numpy(images), torch.from_numpy(targets)


def dp_small_step(group, batch: tuple, accum: int) -> tuple:
    """One float32 step of the small egm_unet on ``batch`` (global; this
    rank's rows with a group): the loss and the state on the CPU."""
    images, targets = shard_batch(group, *batch, accum=accum)
    model = create_model("egm_unet", num_classes=2, base_c=DP_SMALL_BASE_C, fold_bn=False,
                         generator=torch.Generator().manual_seed(SEED)).cuda()
    state = create_train_state(model, warmup_poly_schedule(DP_SMALL_LR, 5, 3, warmup=False))
    kw = dict(input_dtype=torch.float32, group=group)
    step = make_train_step_accum(accum, **kw) if accum > 1 else make_train_step(**kw)
    state, aux = step(state, images.cuda(), targets.cuda())
    return aux["loss"].item(), {k: v.detach().cpu() for k, v in model.state_dict().items()}


def dp_tiny_clip():
    return init_weights(CLIP(tiny_clip_config(64)), torch.Generator().manual_seed(SEED)).cuda()


def dp_tiny_clip_batch() -> tuple:
    gen = torch.Generator().manual_seed(SEED + 10)
    cfg = tiny_clip_config(64)
    return (torch.randn(8, 64, 64, 3, generator=gen),
            *(torch.randint(1, cfg.vocab_size - 1, (8, cfg.context_length), generator=gen)
              for _ in range(2)))


def grad_norm(params, scale: float = 1.0) -> float:
    return math.sqrt(sum((p.grad.double() * scale).pow(2).sum().item() for p in params))


def dp_card_rank(group) -> dict:
    """One of two ranks sharing the card over gloo (CUDA tensors): the
    small egm_unet's step and its --grad-accum 2 step, the tiny Long-CLIP's
    loss across the ranks and gradient norm, and the full-width bf16 step
    (egm_unet base_c 32, global batch 8, 480x480) timed."""
    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"step": dp_small_step(group, dp_small_batch(4), 1),
           "accum2": dp_small_step(group, dp_small_batch(8), 2)}
    model = dp_tiny_clip()
    image, tl, ts = (t.cuda() for t in shard_batch(group, *dp_tiny_clip_batch()))
    reset_launch_counts()
    loss = make_longclip_loss_fn(group=group)(model, image, tl, ts)
    loss.backward()
    params = list(model.parameters())
    total = all_reduce_grads(params, group, loss.detach())[0] / group.world
    out["longclip"] = {"loss": total.item(), "grad_norm": grad_norm(params, 1 / group.world),
                       "k6_launches": launch_counts()["csa_attention"]}
    del model, params
    batches = [shard_batch(group, x, t) for x, t in train_batches(2)]
    state = train_state(BASE_C)
    step = make_train_step(input_dtype=torch.bfloat16, group=group)
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i in range(TRAIN_WARM + DP_TIMED):
        x, t = batches[i % len(batches)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, aux = step(state, x, t)
        losses.append(aux["loss"].item())
        if i >= TRAIN_WARM:
            times.append((time.perf_counter() - t0) * 1e3)
    out["full"] = {"ms_per_step_runs": times, "losses": losses,
                   "collectives": group.collectives,
                   "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    return out


def longclip_oracle(model, batch: tuple, world: int) -> tuple:
    """One process's loss over the whole batch with the PCA proxy taken per
    block of ``batch / world`` rows, as the ranks take it (the JAX
    package's ``dryrun_multichip`` oracle); (loss, gradient norm)."""
    image, tl, ts = (t.cuda() for t in batch)
    norm = lambda t: t / torch.linalg.norm(t, dim=1, keepdim=True)  # noqa: E731
    img_l, txt_l, txt_s = (norm(f.float()) for f in (
        model.encode_image(image), model.encode_text(tl), model.encode_text(ts)))
    img_s = torch.cat([pca_reconstruct(c, 32) for c in img_l.chunk(world)])
    scale = torch.exp(model.logit_scale)
    tgt = torch.arange(image.shape[0], device=image.device)
    ce = lambda s: cross_entropy_smoothed(s, tgt)  # noqa: E731
    l_long = (ce(scale * img_l @ txt_l.T) + ce((scale * (img_l @ txt_l.T)).T)) / 2
    l_short = (ce(scale * img_s @ txt_s.T) + ce((scale * (img_s @ txt_s.T)).T)) / 2
    loss = l_long + 0.1 * l_short
    loss.backward()
    return loss.item(), grad_norm(model.parameters())


def phase_dp_two_ranks_card(dev) -> dict:
    """Two ranks sharing the one H100 over gloo, against one process on the
    whole batch on the same card: the small egm_unet's float32 step and its
    --grad-accum 2 step held at dryrun_multichip's bounds (loss 1e-5
    relative, parameters 1e-4); the full-width bf16 step run and timed, not
    held.  Returns the tiny Long-CLIP's two-rank results for
    ``dp_longclip``."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch(dp_card_rank, 2, "gloo")
    wall = time.perf_counter() - t0
    rec = {"phase": "dp_two_ranks_card", "backend": "gloo", "tensors": "cuda",
           "ranks": 2, "devices": 1, "wall_s": wall, "tf32": False, "card": dev["nvidia_smi"]}
    for case, batch, accum in (("step", 4, 1), ("accum2", 8, 2)):
        loss1, state1 = dp_small_step(None, dp_small_batch(batch), accum)
        (loss0, state0), (loss_r1, state_r1) = ranks[0][case], ranks[1][case]
        rec[case] = {
            "model": "egm_unet", "base_c": DP_SMALL_BASE_C, "batch": batch, "accum": accum,
            "crop": DP_SMALL_SIZE, "dtype": "float32", "loss_dp": loss0, "loss_one": loss1,
            "loss_rel_diff": abs(loss0 - loss1) / abs(loss1),
            "params_max_abs_diff": max((state0[k] - v).abs().max().item()
                                       for k, v in state1.items()),
            "ranks_identical": loss0 == loss_r1 and all(torch.equal(state0[k], state_r1[k])
                                                        for k in state0)}
    full = [r["full"] for r in ranks]
    rec["full"] = {"model": "egm_unet", "base_c": BASE_C, "batch": TRAIN_BATCH,
                   "crop": TRAIN_CROP, "dtype": "bfloat16", "steps_warm": TRAIN_WARM,
                   "steps_timed": DP_TIMED, "ms_per_step": statistics.median(full[0]["ms_per_step_runs"]),
                   **{f"rank{i}": f for i, f in enumerate(full)}}
    rec["full"]["img_per_s"] = TRAIN_BATCH / rec["full"]["ms_per_step"] * 1e3
    emit(rec)
    for case in ("step", "accum2"):
        r = rec[case]
        check(r["loss_rel_diff"] <= 1e-5, f"dp_two_ranks_card {case}: loss {r}")
        check(r["params_max_abs_diff"] < 1e-4, f"dp_two_ranks_card {case}: params {r}")
        check(r["ranks_identical"], f"dp_two_ranks_card {case}: the ranks parted")
    check(all(np.isfinite(f["losses"]).all() for f in full), "dp_two_ranks_card: full losses")
    return [r["longclip"] for r in ranks]


def timed_runs(groups: dict, make_step, make_state, batches, n: int) -> dict:
    """``n`` steps of a fresh state for each entry of ``groups`` (name ->
    None, one process, or a ``DataGroup``), their steps taken in turns (A B,
    B A, A B, ...): CUDA-event ms of each, losses, collectives, kernel
    launches (by difference, as the runs share the counters) and the state
    after, on the card."""
    runs = {name: {"group": g, "state": make_state(), "step": make_step(g), "losses": [],
                   "times": [], "collectives": 0, "launches": dict.fromkeys(SOURCES, 0)}
            for name, g in groups.items()}
    order = list(runs)
    reset_launch_counts()
    for i in range(n):
        for name in (order if i % 2 == 0 else order[::-1]):
            r = runs[name]
            before = (0 if r["group"] is None else r["group"].collectives, launch_counts())
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            r["state"], aux = r["step"](r["state"], *batches[i % len(batches)])
            end.record()
            end.synchronize()
            r["times"].append(start.elapsed_time(end))
            r["losses"].append(aux["loss"].item())
            if r["group"] is not None:
                r["collectives"] += r["group"].collectives - before[0]
            r["launches"] = {k: v + launch_counts()[k] - before[1][k]
                             for k, v in r["launches"].items()}
    for r in runs.values():
        r["after"] = {k: v.detach().clone() for k, v in r["state"].model.state_dict().items()}
    return runs


def same_bits(a: dict, b: dict) -> list:
    """The keys where two runs' losses or states differ in any bit."""
    bad = [] if a["losses"] == b["losses"] else ["losses"]
    return bad + [k for k in a["after"] if not torch.equal(a["after"][k], b["after"][k])]


def dp_train_world1(group, dev) -> dict:
    """The data-parallel train step under an NCCL group of one at
    phase_train's configuration (egm_unet base_c 32, bf16, batch 8, 480x480,
    3 warm-up and 10 timed steps) beside the one-process step from the same
    state and batches, their steps in turns: bit for bit (cuDNN's
    deterministic algorithms in both), ms per step, collectives per step,
    and their time in one profiled step (``dp_train_profile.txt``)."""
    batches = train_batches(4)
    n = TRAIN_WARM + TRAIN_TIMED
    make_step = lambda g: make_train_step(input_dtype=torch.bfloat16, group=g)  # noqa: E731
    make_state = lambda: train_state(BASE_C)  # noqa: E731
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = timed_runs({"plain": None, "dp": group}, make_step, make_state, batches, n)
        plain, dp = runs["plain"], runs["dp"]
        x, t = batches[0]
        before = group.collectives
        prof = phase_profile("dp_train_profile", lambda: dp["step"](dp["state"], x, t),
                             "dp_train_profile.txt", {"nccl": "nccl"}, host={"nccl": "nccl:"},
                             require=False)
        profiled = group.collectives - before
        differ = same_bits(plain, dp)
        del runs, plain["state"], dp["state"]
        if differ:  # is the one-process step itself reproducible?
            again = timed_runs({"plain": None}, make_step, make_state, batches, n)["plain"]
            reproducible = not same_bits(plain, again)
        else:
            reproducible = True
    finally:
        torch.backends.cudnn.deterministic = deterministic
    rec = {"phase": "dp_train", "backend": "nccl", "world": group.world,
           "model": "egm_unet", "base_c": BASE_C, "batch": TRAIN_BATCH, "crop": TRAIN_CROP,
           "dtype": "bfloat16", "cudnn_deterministic": True, "in_turns": True,
           "steps_warm": TRAIN_WARM, "steps_timed": TRAIN_TIMED,
           "ms_per_step": statistics.median(dp["times"][TRAIN_WARM:]),
           "plain_ms_per_step": statistics.median(plain["times"][TRAIN_WARM:]),
           "ms_per_step_runs": dp["times"][TRAIN_WARM:],
           "plain_ms_per_step_runs": plain["times"][TRAIN_WARM:],
           "collectives_per_step": dp["collectives"] / n, "collectives_profiled_step": profiled,
           "nccl_device_ms": prof["by_kernel_ms"]["nccl"],
           "nccl_kernels": prof["by_kernel_launches"]["nccl"],
           "nccl_host_ms": prof["host_nccl_ms"],
           "nccl_host_calls": prof.get("host_nccl_calls"),
           "profiled_step_device_ms": prof["device_ms"], "profiled_step_wall_ms": prof["wall_ms"],
           "losses": dp["losses"], "bit_identical": not differ, "differ": differ[:10],
           "plain_reproducible": reproducible, "launches": dp["launches"],
           "card": dev["nvidia_smi"]}
    emit(rec)
    check(not differ, f"dp_train: world-1 step differs from the one-process step at "
                      f"{differ[:5]} (one-process reproducible: {reproducible})")
    check(not any(dp["launches"].values()), f"dp_train: kernels launched {dp['launches']}")
    return dp["launches"]


def dp_longclip_world1(group, dev, two_ranks: list) -> dict:
    """cli/train_longclip.py's data-parallel step under an NCCL group of one
    at phase_train_longclip's configuration (random ViT-B/16, batch 32,
    float32, TF32 off) beside the one-process step, from one seed, their
    steps in turns: bit for bit over 4 steps, ms per step after the first,
    K6's launches; then the tiny Long-CLIP on
    two ranks sharing the card (``dp_two_ranks_card``'s spawn) against one
    process with the PCA proxy per rank block: the loss within 1e-4, the
    gradient norm within 1e-3 relative (``dryrun_multichip``'s bars)."""
    gen = torch.Generator().manual_seed(SEED + 6)
    res, ctx = VIT_B16.image_resolution, VIT_B16.context_length
    batches = [(torch.randn(LONGCLIP_BATCH, res, res, 3, generator=gen).cuda(),
                *(torch.randint(1, VIT_B16.vocab_size - 1, (LONGCLIP_BATCH, ctx),
                                generator=gen).cuda() for _ in range(2)))
               for _ in range(DP_LONGCLIP_STEPS)]

    def make_state():
        model = init_weights(CLIP(VIT_B16), torch.Generator().manual_seed(SEED)).cuda()
        return create_longclip_state(model, lr=1e-6, warmup_steps=2,
                                     total_steps=LONGCLIP_STEPS)

    make_step = lambda g: make_longclip_train_step(group=g)  # noqa: E731
    runs = timed_runs({"plain": None, "dp": group}, make_step, make_state, batches,
                      DP_LONGCLIP_STEPS)
    plain, dp = runs["plain"], runs["dp"]
    differ = same_bits(plain, dp)
    del runs, plain["state"], dp["state"]
    torch.cuda.empty_cache()

    model = dp_tiny_clip()
    loss1, gnorm1 = longclip_oracle(model, dp_tiny_clip_batch(), len(two_ranks))
    two = two_ranks[0]
    rec = {"phase": "dp_longclip", "backend": "nccl", "world": group.world,
           "model": "CLIP(VIT_B16), random tower", "batch": LONGCLIP_BATCH, "dtype": "float32",
           "tf32": False, "steps": DP_LONGCLIP_STEPS,
           "ms_per_step_runs": dp["times"], "plain_ms_per_step_runs": plain["times"],
           "ms_per_step": statistics.median(dp["times"][1:]),
           "plain_ms_per_step": statistics.median(plain["times"][1:]),
           "collectives_per_step": dp["collectives"] / DP_LONGCLIP_STEPS,
           "in_turns": True,
           "losses": dp["losses"], "bit_identical": not differ, "differ": differ[:10],
           "launches": dp["launches"], "plain_launches": plain["launches"],
           "two_ranks_card": {"backend": "gloo", "model": "tiny_clip_config(64)", "batch": 8,
                              "loss_dp": two["loss"], "loss_one": loss1,
                              "loss_abs_diff": abs(two["loss"] - loss1),
                              "grad_norm_dp": two["grad_norm"], "grad_norm_one": gnorm1,
                              "grad_norm_rel_diff": abs(two["grad_norm"] - gnorm1)
                              / max(gnorm1, 1.0),
                              "k6_launches_per_rank": [r["k6_launches"] for r in two_ranks]},
           "card": dev["nvidia_smi"]}
    emit(rec)
    want = {k: n * DP_LONGCLIP_STEPS for k, n in PER_LONGCLIP_STEP.items()}
    check(not differ, f"dp_longclip: world-1 step differs from the one-process step at "
                      f"{differ[:5]}")
    check(dp["launches"] == want, f"dp_longclip launches {dp['launches']} != {want}")
    t = rec["two_ranks_card"]
    check(t["loss_abs_diff"] < 1e-4, f"dp_longclip two ranks: loss {t}")
    check(t["grad_norm_rel_diff"] < 1e-3, f"dp_longclip two ranks: gradient norm {t}")
    check(all(n == 1 for n in t["k6_launches_per_rank"]), f"dp_longclip two ranks: K6 {t}")
    return dp["launches"]


# ------------------------------------------- spatial and tensor parallel

# ranks sharing the one card over gloo (CUDA tensors through the host), each
# a process; float32, TF32 off.  sp_card: egm_unet at full width on a 1 x 2
# grid; dp_sp_card: dryrun_multichip's phase 1b (2 x 2, base_c 16, 64 px);
# tp_card: the Long-CLIP ViT-B/16 tower Megatron-split over 2 model ranks;
# dp_tp_card: dryrun_multichip's phase 2 tiny Long-CLIP on a 2 x 2 grid
SP_BATCH, SP_MEM_SIZE, SP_TIMED = 2, 1024, 3
DP_SP_BASE_C = 16
TP_BATCH, TP_TIMED = 8, 3
CSA_TP_SHAPE = (TP_BATCH, (224 // 16) ** 2 + 1, 768 // 2, 12 // 2)  # local heads


def f32_exact() -> None:
    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def sp_batch(batch: int, size: int, seed: int) -> tuple:
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((batch, size, size, 3)).astype(np.float32)
    targets = rng.integers(0, 2, (batch, size, size)).astype(np.int64)
    targets[rng.random(targets.shape) < 0.05] = 255
    return torch.from_numpy(images), torch.from_numpy(targets)


def sp_full_batch() -> tuple:
    """The first ``SP_BATCH`` of ``train_batches``' 480 crops, on the CPU."""
    x, t = train_batches(1)[0]
    return x[:SP_BATCH].cpu(), t[:SP_BATCH].cpu()


def sp_state(base_c: int, sched):
    model = create_model("egm_unet", num_classes=2, base_c=base_c, fold_bn=False,
                         generator=torch.Generator().manual_seed(SEED))
    return create_train_state(model.cuda(), sched)


def sp_step(grid, base_c: int, sched, batch: tuple, timed: int = 0,
            dtype=torch.float32) -> dict:
    """One step of egm_unet (base_c ``base_c``, ``dtype``: float32, or
    float64 for a reference) on ``batch`` (this rank's part of it on a
    grid; the whole of it without one) from the seeded weights, and the
    eval logits of those weights before it: the loss, the state and the
    gradients after it on the CPU, the collectives and kernel launches of
    the step; then ``timed`` more steps timed."""
    state = sp_state(base_c, sched)
    state.model.to(dtype)
    if grid is None:
        x, t = batch
        ctx, kw = contextlib.nullcontext(), {}
    else:
        x, t = shard_batch_spatial(grid, *batch)
        ctx = contextlib.ExitStack()
        ctx.enter_context(use_data_group(grid.world))
        ctx.enter_context(use_spatial_group(grid.inner, batch[0].shape[1]))
        kw = dict(group=grid.world, spatial=grid.inner)
    x, t = x.cuda(), t.cuda()
    with torch.no_grad(), ctx:
        logits = state.model.eval()(x.to(dtype))["out"].cpu()
    step = make_train_step(input_dtype=dtype, **kw)
    counts = (lambda: (0, 0)) if grid is None else (
        lambda: (grid.inner.collectives, grid.world.collectives))
    before = counts()
    reset_launch_counts()
    state, aux = step(state, x, t)
    out = {"loss": aux["loss"].item(), "logits": logits,
           "launches": launch_counts(),
           "halo_collectives": counts()[0] - before[0],
           "reduce_collectives": counts()[1] - before[1],
           "state": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
           "grads": {k: p.grad.detach().cpu() for k, p in state.model.named_parameters()}}
    times = []
    for _ in range(timed):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, aux = step(state, x, t)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    out["ms_per_step_runs"] = times
    return out


def sp_peak_memory(grid) -> float:
    """Peak device memory (GiB, ``max_memory_allocated`` less what the
    process held before) of one float32 step of the full-width egm_unet at
    1024 x 1024, batch 1, from a fresh state: this rank's rows of it on a
    grid."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    sched = warmup_poly_schedule(TRAIN_LR, 876 // TRAIN_BATCH, 200)
    batch = sp_batch(1, SP_MEM_SIZE, SEED + 12)
    state = sp_state(BASE_C, sched)
    if grid is None:
        step, (x, t) = make_train_step(input_dtype=torch.float32), batch
    else:
        step = make_train_step(input_dtype=torch.float32, group=grid.world,
                               spatial=grid.inner)
        x, t = shard_batch_spatial(grid, *batch)
    state, aux = step(state, x.cuda(), t.cuda())
    check(bool(math.isfinite(aux["loss"].item())), "sp peak memory: loss not finite")
    return (torch.cuda.max_memory_allocated() - held) / 2 ** 30


def sp_card_rank(grid) -> dict:
    """One rank of sp_card's 1 x 2 grid: the checked and timed steps at 480,
    the peak memory at 1024."""
    f32_exact()
    sched = warmup_poly_schedule(TRAIN_LR, 876 // TRAIN_BATCH, 200)
    out = sp_step(grid, BASE_C, sched, sp_full_batch(), SP_TIMED)
    out["peak_mem_gib_1024"] = sp_peak_memory(grid)
    return out


def dp_sp_card_rank(grid) -> dict:
    f32_exact()
    sched = warmup_poly_schedule(DP_SMALL_LR, 5, 3, warmup=False)
    return sp_step(grid, DP_SP_BASE_C, sched, sp_batch(4, DP_SMALL_SIZE, SEED + 9))


def rows_of(ranks: list, key: str) -> torch.Tensor:
    return torch.cat([r[key] for r in ranks], dim=1)


def sp_compare(name: str, ranks: list, one: dict, again: dict, f64: dict, grid: tuple,
               dev, **extra) -> dict:
    """Held at dryrun_multichip's bars: the loss 1e-5 relative, the
    parameters and statistics after the step 1e-4, the eval logits 1e-4;
    the gradients reported against ``leaf_ratio``'s 1e-3 bar, beside the
    one-process step's own against a second run of it (``again``) and both
    against the one-process step in float64 (``f64``), the float32
    gradients' own distance from exact arithmetic."""
    n_data, n_inner = grid
    logits = torch.cat([rows_of(ranks[d * n_inner:(d + 1) * n_inner], "logits")
                        for d in range(n_data)], dim=0)
    r0 = ranks[0]
    rec = {"phase": name, "backend": "gloo", "tensors": "cuda", "grid": list(grid),
           "devices": 1, "dtype": "float32", "tf32": False, **extra,
           "loss_sp": r0["loss"], "loss_one": one["loss"],
           "loss_rel_diff": abs(r0["loss"] - one["loss"]) / abs(one["loss"]),
           "params_max_abs_diff": max((r0["state"][k] - v).abs().max().item()
                                      for k, v in one["state"].items()),
           "logits_max_abs_diff": (logits - one["logits"]).abs().max().item(),
           "logits_max_abs": one["logits"].abs().max().item(),
           "grad_worst_over_tol": list(leaf_ratio(r0["grads"], one["grads"], 1e-3)),
           "grad_one_vs_one_worst_over_tol": list(leaf_ratio(again["grads"], one["grads"],
                                                             1e-3)),
           "grad_vs_float64_worst_over_tol": {
               "row_split": list(leaf_ratio(r0["grads"], f64["grads"], 1e-3)),
               "one_process": list(leaf_ratio(one["grads"], f64["grads"], 1e-3))},
           "ranks_identical": all(r["loss"] == r0["loss"] and all(
               torch.equal(r["state"][k], v) for k, v in r0["state"].items()) for r in ranks),
           "halo_collectives_per_step": r0["halo_collectives"],
           "reduce_collectives_per_step": r0["reduce_collectives"],
           "launches": {k: sum(r["launches"][k] for r in ranks) for k in SOURCES},
           "card": dev["nvidia_smi"]}
    return rec


def sp_check(rec: dict) -> None:
    name = rec["phase"]
    check(rec["loss_rel_diff"] <= 1e-5, f"{name}: loss {rec['loss_sp']} vs {rec['loss_one']}")
    check(rec["params_max_abs_diff"] < 1e-4, f"{name}: params {rec['params_max_abs_diff']}")
    check(rec["logits_max_abs_diff"] <= 1e-4 * max(1.0, rec["logits_max_abs"]),
          f"{name}: eval logits {rec['logits_max_abs_diff']}")
    check(rec["ranks_identical"], f"{name}: the ranks parted")
    check(rec["halo_collectives_per_step"] > 0, f"{name}: no halo exchanged")
    check(not any(rec["launches"].values()), f"{name}: kernels launched {rec['launches']}")


def phase_sp_card(dev) -> None:
    """egm_unet at full width (base_c 32, 2 classes, the BatchNorm graph,
    float32, TF32 off) on a 1 x 2 grid: one step at batch 2 on 480 x 480
    crops against one process on the card (dryrun_multichip's bars: loss
    1e-5 relative, parameters 1e-4; eval logits 1e-4), ms per step, the
    halo and reduce collectives per step, and each rank's peak memory
    against one process at 1024 x 1024, batch 1 (at most 0.6 of it)."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch(sp_card_rank, 2, "gloo", grid=(1, 2))
    wall = time.perf_counter() - t0
    f32_exact()
    sched = warmup_poly_schedule(TRAIN_LR, 876 // TRAIN_BATCH, 200)
    one = sp_step(None, BASE_C, sched, sp_full_batch(), SP_TIMED)
    again = sp_step(None, BASE_C, sched, sp_full_batch())
    f64 = sp_step(None, BASE_C, sched, sp_full_batch(), dtype=torch.float64)
    mem_one = sp_peak_memory(None)
    rec = sp_compare("sp_card", ranks, one, again, f64, (1, 2), dev, wall_s=wall,
                     model="egm_unet",
                     base_c=BASE_C, batch=SP_BATCH, crop=TRAIN_CROP,
                     lr_first_step=sched(0),
                     ms_per_step=statistics.median(ranks[0]["ms_per_step_runs"]),
                     ms_per_step_runs=[r["ms_per_step_runs"] for r in ranks],
                     plain_ms_per_step=statistics.median(one["ms_per_step_runs"]),
                     peak_mem_1024={"size": SP_MEM_SIZE, "batch": 1,
                                    "rank_gib": [r["peak_mem_gib_1024"] for r in ranks],
                                    "one_process_gib": mem_one})
    rec["peak_mem_1024"]["worst_rank_share"] = max(
        rec["peak_mem_1024"]["rank_gib"]) / mem_one
    emit(rec)
    sp_check(rec)
    check(rec["peak_mem_1024"]["worst_rank_share"] <= 0.6,
          f"sp_card: a rank peaks at {rec['peak_mem_1024']['worst_rank_share']} of one "
          f"process's memory at {SP_MEM_SIZE}")


def phase_dp_sp_card(dev) -> None:
    """dryrun_multichip's phase 1b: 2 data x 2 spatial ranks, egm_unet base_c
    16 at 64 px, batch 4, against one process on the card; sp_card's bars."""
    torch.cuda.empty_cache()
    ranks = launch(dp_sp_card_rank, 4, "gloo", grid=(2, 2))
    f32_exact()
    one, again, f64 = (sp_step(None, DP_SP_BASE_C,
                               warmup_poly_schedule(DP_SMALL_LR, 5, 3, warmup=False),
                               sp_batch(4, DP_SMALL_SIZE, SEED + 9), dtype=dtype)
                       for dtype in (torch.float32, torch.float32, torch.float64))
    rec = sp_compare("dp_sp_card", ranks, one, again, f64, (2, 2), dev, model="egm_unet",
                     base_c=DP_SP_BASE_C, batch=4, crop=DP_SMALL_SIZE, lr=DP_SMALL_LR)
    emit(rec)
    sp_check(rec)


def tp_batch(cfg: CLIPConfig, batch: int, seed: int) -> tuple:
    gen = torch.Generator().manual_seed(seed)
    res = cfg.image_resolution
    return (torch.randn(batch, res, res, 3, generator=gen),
            *(torch.randint(1, cfg.vocab_size - 1, (batch, cfg.context_length), generator=gen)
              for _ in range(2)))


def tp_clip(cfg: CLIPConfig):
    return init_weights(CLIP(cfg), torch.Generator().manual_seed(SEED)).cuda()


def tp_loss(model, batch, group, world_data: int):
    """The Long-CLIP loss of this rank's rows (data group ``group``), its
    backward, and the gradients as the train step reduces them (summed over
    the data ranks, divided by their number); returns the loss."""
    loss = make_longclip_loss_fn(group=group)(model, *batch)
    loss.backward()
    params = [p for p in model.parameters() if p.requires_grad]
    if group is None:
        return loss.item()
    total = all_reduce_grads(params, group, loss.detach())[0] / world_data
    for p in params:
        p.grad.div_(world_data)
    return total.item()


def tp_rank(grid, cfg: CLIPConfig, batch: tuple, ref_path: str, timed: int) -> dict:
    """One rank of a grid whose inner ranks split the CLIP towers: the loss
    and its gradients (reassembled by ``gather_clip_state``) held leaf by
    leaf against one process's in ``ref_path`` (``leaf_ratio``'s 1e-3 bar),
    K6's launches in the checked pass, and ``timed`` passes timed."""
    f32_exact()
    model = shard_clip(tp_clip(cfg), grid.inner)
    local = tuple(t.cuda() for t in shard_batch(grid.data, *batch))
    before = grid.inner.collectives
    reset_launch_counts()
    loss = tp_loss(model, local, grid.data, grid.n_data)
    launches = launch_counts()
    collectives = grid.inner.collectives - before
    grads = gather_clip_state(model, grid.inner, grads=True)
    ref = torch.load(ref_path, weights_only=False)
    out = {"loss": loss, "launches": launches, "model_collectives_per_pass": collectives,
           "grad_norm": math.sqrt(sum(g.double().pow(2).sum().item()
                                      for g in grads.values() if g is not None)),
           "grad_worst_over_tol": list(leaf_ratio(grads, ref["grads"], 1e-3)),
           "heads": [m.heads for m in model.modules() if hasattr(m, "heads")]}
    times = []
    for _ in range(timed):
        model.zero_grad(set_to_none=True)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        tp_loss(model, local, grid.data, grid.n_data)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    out["ms_per_pass_runs"] = times
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def tp_reference(cfg: CLIPConfig, batch: tuple, n_data: int, path: str, timed: int) -> dict:
    """One process on the card: the loss over the whole batch with the PCA
    proxy per data rank's block (``longclip_oracle``), its gradients saved
    to ``path``, and ``timed`` passes of the one-process loss timed."""
    f32_exact()
    model = tp_clip(cfg)
    loss, gnorm = longclip_oracle(model, batch, n_data)
    torch.save({"grads": {k: p.grad.detach().cpu() for k, p in model.named_parameters()
                          if p.grad is not None}}, path)
    full = tuple(t.cuda() for t in batch)
    times = []
    for _ in range(timed):
        model.zero_grad(set_to_none=True)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        tp_loss(model, full, None, 1)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return {"loss": loss, "grad_norm": gnorm, "ms_per_pass_runs": times,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def tp_phase(name: str, cfg: CLIPConfig, grid: tuple, batch_size: int, timed: int,
             dev, **extra) -> dict:
    """A grid of data x model ranks on the card against one process: the
    loss within 1e-4, the gradient norm within 1e-3 relative
    (dryrun_multichip's bars), every gradient leaf within 1e-3 of its
    largest + 1e-6 (text_train_card_vs_cpu's), one K6 launch per rank."""
    torch.cuda.empty_cache()
    batch = tp_batch(cfg, batch_size, SEED + 13)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "grads.pt")
        one = tp_reference(cfg, batch, grid[0], path, timed)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = launch(tp_rank, grid[0] * grid[1], "gloo", cfg, batch, path, timed, grid=grid)
        wall = time.perf_counter() - t0
    r0 = ranks[0]
    launches = {k: sum(r["launches"][k] for r in ranks) for k in SOURCES}
    rec = {"phase": name, "backend": "gloo", "tensors": "cuda", "grid": list(grid),
           "devices": 1, "dtype": "float32", "tf32": False, "batch": batch_size,
           "wall_s": wall, **extra, "loss_tp": r0["loss"], "loss_one": one["loss"],
           "loss_abs_diff": abs(r0["loss"] - one["loss"]),
           "grad_norm_tp": r0["grad_norm"], "grad_norm_one": one["grad_norm"],
           "grad_norm_rel_diff": abs(r0["grad_norm"] - one["grad_norm"])
           / max(one["grad_norm"], 1.0),
           "grad_worst_over_tol": [r["grad_worst_over_tol"] for r in ranks],
           "k6_launches_per_rank": [r["launches"]["csa_attention"] for r in ranks],
           "launches": launches, "heads_rank0": r0["heads"],
           "model_collectives_per_pass": r0["model_collectives_per_pass"],
           "ms_per_pass": statistics.median(r0["ms_per_pass_runs"]) if timed else None,
           "ms_per_pass_runs": [r["ms_per_pass_runs"] for r in ranks],
           "plain_ms_per_pass": statistics.median(one["ms_per_pass_runs"]) if timed else None,
           "peak_mem_gib": [r["peak_mem_gib"] for r in ranks],
           "plain_peak_mem_gib": one["peak_mem_gib"], "card": dev["nvidia_smi"]}
    emit(rec)
    check(rec["loss_abs_diff"] < 1e-4, f"{name}: loss {r0['loss']} vs {one['loss']}")
    check(rec["grad_norm_rel_diff"] < 1e-3, f"{name}: gradient norm {rec['grad_norm_rel_diff']}")
    check(all(w[0] <= 1.0 for w in rec["grad_worst_over_tol"]),
          f"{name}: a gradient leaf past 1e-3 of its largest: {rec['grad_worst_over_tol']}")
    check(rec["k6_launches_per_rank"] == [1] * len(ranks),
          f"{name}: K6 launches per rank {rec['k6_launches_per_rank']}")
    return launches


def phase_tp_card(dev, records: list) -> dict:
    """The Long-CLIP ViT-B/16 tower with the 248-token text tower (random
    weights) Megatron-split over 1 data x 2 model ranks, batch 8, against one
    process; K6 runs on each rank's 6 of the 12 vision heads, on the
    ``chunk`` views of its [8, 197, 1152] in_proj output, and is held here
    against ``csa_plain`` at that shape.  Returns the launches of the
    checked pass (K6 once per rank)."""
    f32_exact()
    records.append(kernel_record("tp_card: clip.visual.resblock11, 6 local heads",
                                 csa_call(CSA_TP_SHAPE, torch.float32, views=True), 5))
    check(records[-1]["variant"] == PATH_VARIANTS["csa_attention"]["float32"],
          f"K6 float32 at {CSA_TP_SHAPE}: variant {records[-1]['variant']}")
    return tp_phase("tp_card", VIT_B16, (1, 2), TP_BATCH, TP_TIMED, dev,
                    model="CLIP(VIT_B16), random towers")


def phase_dp_tp_card(dev) -> None:
    """dryrun_multichip's phase 2: its tiny Long-CLIP on 2 data x 2 model
    ranks, batch 8, against one process with the PCA proxy per data rank."""
    cfg = CLIPConfig(embed_dim=32, image_resolution=32, vision_layers=2, vision_width=64,
                     vision_patch_size=16, context_length=16, vocab_size=128,
                     transformer_width=64, transformer_heads=2, transformer_layers=2,
                     long_clip=True)
    tp_phase("dp_tp_card", cfg, (2, 2), 8, 0, dev, model="dryrun_multichip's tiny Long-CLIP")


# ------------------------------------------- reference checkpoints, the tail

CONVERT_MODELS = ("egm_unet", "egm_unet_ab")  # with MCA, and the yuan layout
CONVERT_ROUTES = (("gemm", "matmul"), ("pair", "fused"))
N_EVAL_IMAGES = 4  # cli/predict.py --synthetic writes four


def reference_egm_state_dict(use_mca: bool, base_c: int = BASE_C, num_classes: int = 2,
                             seed: int = SEED) -> dict:
    """A seeded state dict in the reference GRFBUNet's key layout
    (src/EGM-UNet.py's module tree; ``use_mca=False`` is the yuan layout,
    whose encoder Sequential has no MCALayer at index 3), enumerated here
    from the reference's shapes, independent of the port's converter:
    conv kernels at He scale, BatchNorms with non-trivial affine parameters
    and running statistics."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen) * std

    def conv(key, cin, cout, k=3, bias=False, groups=1):
        fan = cin // groups * k * k
        sd[f"{key}.weight"] = randn(cout, cin // groups, k, k, std=math.sqrt(2.0 / fan))
        if bias:
            sd[f"{key}.bias"] = randn(cout, std=0.05)

    def bn(key, c):
        sd[f"{key}.weight"] = 0.7 + 0.6 * torch.rand(c, generator=gen)
        sd[f"{key}.bias"] = randn(c, std=0.05)
        sd[f"{key}.running_mean"] = randn(c, std=0.1)
        sd[f"{key}.running_var"] = 0.5 + 1.5 * torch.rand(c, generator=gen)
        sd[f"{key}.num_batches_tracked"] = torch.tensor(1000)

    def basic(key, cin, cout, k=3, groups=1):
        conv(f"{key}.conv", cin, cout, k, groups=groups)
        bn(f"{key}.bn", cout)

    def double_conv(prefix, cin, cout, mid=None):
        mid = mid or cout
        conv(f"{prefix}.0", cin, mid)
        bn(f"{prefix}.1", mid)
        conv(f"{prefix}.3", mid, cout)
        bn(f"{prefix}.4", cout)

    def edge_aware(prefix, c):
        conv(f"{prefix}.weight_generator.0", c, c, 1, bias=True)
        bn(f"{prefix}.weight_generator.1", c)

    def mca(prefix, c):
        temp = round(abs((math.log2(c) - 1) / 1.5))
        for gate, k in (("h_cw", 3), ("w_hc", 3), ("c_hw", max(temp if temp % 2 else temp - 1, 1))):
            sd[f"{prefix}.{gate}.conv.weight"] = randn(1, 1, 1, k, std=0.5)
            sd[f"{prefix}.{gate}.weight"] = torch.rand(2, generator=gen)

    def egrfb(prefix, cin, cout):
        i = max(cin // 8, 4)
        edge_aware(f"{prefix}.edge_enhancer", cin)
        basic(f"{prefix}.branch_dir.0", cin, 2 * i, 1)
        basic(f"{prefix}.branch_dir.1", 2 * i, 2 * i, 3)
        basic(f"{prefix}.branch_dir.2", 2 * i, 2 * i, 1)
        basic(f"{prefix}.branch_edge.0", cin, i, 1)
        edge_aware(f"{prefix}.branch_edge.1", i)
        basic(f"{prefix}.branch_edge.2", i, 2 * i, 3, groups=i)
        basic(f"{prefix}.branch_edge.3", 2 * i, 2 * i, 3)
        basic(f"{prefix}.branch_edge.4", 2 * i, 2 * i, 1)
        basic(f"{prefix}.branch_ctx.0", cin, i, 3)
        basic(f"{prefix}.branch_ctx.1", i, 2 * i, 3, groups=2)
        basic(f"{prefix}.branch_ctx.2", 2 * i, 2 * i, 3)
        basic(f"{prefix}.branch_ctx.3", 2 * i, 2 * i, 1)
        f, dim = f"{prefix}.fusion_conv", cout // 4
        conv(f"{f}.down", 2 * (cin + 6 * i), dim, 1, bias=True)
        for name, k in (("conv_3x3", 3), ("conv_5x5", 5), ("conv_7x7", 7)):
            conv(f"{f}.{name}", dim, dim, k, bias=True)
        conv(f"{f}.spatial_attention.conv1", 2, 1, 7)
        conv(f"{f}.channel_attention.fc.0", dim, dim // 4, 1)
        conv(f"{f}.channel_attention.fc.2", dim // 4, dim, 1)
        conv(f"{f}.up", dim, cout, 1, bias=True)
        basic(f"{prefix}.shortcut", cin, cout, 1)
        conv(f"{prefix}.target_enhancer.0", cout, 3, 3, bias=True)

    c = base_c
    double_conv("in_conv", 3, c)
    for k, (ci, co) in enumerate([(c, 2 * c), (2 * c, 4 * c), (4 * c, 8 * c),
                                  (8 * c, 8 * c)], start=1):
        p = f"down{k}.1"
        conv(f"{p}.0", ci, co)
        bn(f"{p}.1", co)
        if use_mca:
            mca(f"{p}.3", co)
        i2 = 4 if use_mca else 3
        conv(f"{p}.{i2}", co, co)
        bn(f"{p}.{i2 + 1}", co)
        egrfb(f"{p}.{i2 + 3}", co, co)
    dim, half = 8 * c, 4 * c
    conv("attn1.proj_in", dim, 3 * half, 1, bias=True)
    conv("attn1.dwconv", 2 * half, 2 * half, 3, bias=True, groups=2 * half)
    sd["attn1.scale"] = torch.tensor(1.0)
    for g in range(2):
        hid = max(half // 8, 8)
        conv(f"attn1.gate_convs.{g}.0", half, hid, 1, bias=True)
        conv(f"attn1.gate_convs.{g}.2", hid, 1, 1, bias=True)
    conv("attn1.transform_convs.0", half, half, 1, bias=True)
    conv("attn1.proj_out", half, dim, 1, bias=True)
    for k, (ci, co) in enumerate([(16 * c, 4 * c), (8 * c, 2 * c), (4 * c, c), (2 * c, c)],
                                 start=1):
        double_conv(f"up{k}.conv", ci, co, mid=ci // 2)
    conv("out_conv.0", c, num_classes, 1, bias=True)
    return sd


def reference_clip_state_dict(seed: int = SEED) -> dict:
    """A seeded OpenAI ViT-B/16 CLIP state dict in the reference's key
    layout (77 text positions, no ``positional_embedding_res``): the
    widths of ``VIT_B16``, which ``--stretch-long`` turns into Long-CLIP."""
    gen = torch.Generator().manual_seed(seed)
    cfg = VIT_B16

    def randn(*shape, std):
        return torch.randn(shape, generator=gen) * std

    w, tw, p = cfg.vision_width, cfg.transformer_width, cfg.vision_patch_size
    sd = {"visual.conv1.weight": randn(w, 3, p, p, std=(3 * p * p) ** -0.5),
          "visual.class_embedding": randn(w, std=w ** -0.5),
          "visual.positional_embedding": randn((cfg.image_resolution // p) ** 2 + 1, w,
                                               std=w ** -0.5),
          "visual.proj": randn(w, cfg.embed_dim, std=w ** -0.5),
          "token_embedding.weight": randn(cfg.vocab_size, tw, std=0.02),
          "positional_embedding": randn(77, tw, std=0.01),
          "text_projection": randn(tw, cfg.embed_dim, std=tw ** -0.5),
          "logit_scale": torch.tensor(math.log(1 / 0.07))}
    for ln, width in (("visual.ln_pre", w), ("visual.ln_post", w), ("ln_final", tw)):
        sd[f"{ln}.weight"] = 1 + randn(width, std=0.1)
        sd[f"{ln}.bias"] = randn(width, std=0.05)
    for prefix, width, depth in (("visual.transformer.resblocks", w, cfg.vision_layers),
                                 ("transformer.resblocks", tw, cfg.transformer_layers)):
        for i in range(depth):
            b = f"{prefix}.{i}"
            for ln in ("ln_1", "ln_2"):
                sd[f"{b}.{ln}.weight"] = 1 + randn(width, std=0.1)
                sd[f"{b}.{ln}.bias"] = randn(width, std=0.05)
            for name, (o, i_) in (("attn.in_proj", (3 * width, width)),
                                  ("attn.out_proj", (width, width)),
                                  ("mlp.c_fc", (4 * width, width)),
                                  ("mlp.c_proj", (width, 4 * width))):
                key = f"{b}.{name}_weight" if name == "attn.in_proj" else f"{b}.{name}.weight"
                sd[key] = randn(o, i_, std=i_ ** -0.5)
                bkey = f"{b}.{name}_bias" if name == "attn.in_proj" else f"{b}.{name}.bias"
                sd[bkey] = randn(o, std=0.02)
    return sd


def convert_cli_run(args: list) -> subprocess.Popen:
    """``python -m egm_unet_torch.cli.convert ARGS`` as a user runs it, from
    the checkout's root; not waited for."""
    return subprocess.Popen([sys.executable, "-m", "egm_unet_torch.cli.convert", *args],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def convert_all(work: Path) -> dict:
    """The reference checkpoints written as train.py saves them, converted by
    three ``cli/convert.py`` processes started together: the two EGM layouts
    (``--kind egm``) and the CLIP one (``--kind clip --stretch-long``)."""
    t0 = time.perf_counter()
    procs, out = {}, {"dirs": {}}
    for name in CONVERT_MODELS:
        pth = work / f"{name}_model_best.pth"
        sd = reference_egm_state_dict(use_mca=name == "egm_unet", base_c=BASE_C)
        torch.save({"model": sd, "optimizer": {}, "epoch": 1}, pth)
        out["dirs"][name] = work / f"{name}_converted"
        procs[name] = convert_cli_run(["--kind", "egm", "--torch", str(pth), "--out",
                                       str(out["dirs"][name]), "--model", name,
                                       "--base-c", str(BASE_C), "--num-classes", "2"])
    out["clip_pt"] = work / "clip_vit_b16.pt"
    out["clip_out"] = work / "clip_converted.pt"
    torch.save(reference_clip_state_dict(), out["clip_pt"])
    procs["clip"] = convert_cli_run(["--kind", "clip", "--torch", str(out["clip_pt"]),
                                     "--out", str(out["clip_out"]), "--stretch-long"])
    logs = {}
    for name, proc in procs.items():
        logs[name], _ = proc.communicate(timeout=300)
        check(proc.returncode == 0, f"cli/convert.py for {name} exited "
                                    f"{proc.returncode}:\n{logs[name]}")
    out["seconds"] = time.perf_counter() - t0
    out["logs"] = {k: v.strip().splitlines()[-1][:200] for k, v in logs.items()}
    return out


def converted_predictor(directory, name, conv_impl, upsample_impl, dtype, device,
                        batch=BATCH):
    cfg = PredictorConfig(model_name=name, base_c=BASE_C, num_classes=2, batch_size=batch,
                          dtype=dtype, conv_impl=conv_impl, upsample_impl=upsample_impl)
    return Predictor.from_checkpoint(str(directory), cfg, device=device)


def eval_confmat(gt_dir: Path, pred_dir: Path, names) -> np.ndarray:
    """The evaluator's confusion matrix accumulated here in numpy from the
    same PNGs: /255 rounded labels, ground truth by rows."""
    hist = np.zeros((2, 2), np.int64)
    for name in names:
        gt = np.asarray(Image.open(gt_dir / f"{name}.png").convert("L"))
        pr = np.asarray(Image.open(pred_dir / f"{name}.png").convert("L"))
        g = np.rint(gt / 255.0).astype(np.int64).ravel()
        p = np.rint(pr / 255.0).astype(np.int64).ravel()
        hist += np.bincount(2 * g + p, minlength=4).reshape(2, 2)
    return hist


def phase_convert_serve(dev, conv: dict) -> dict:
    """Reference checkpoints of ``egm_unet`` and ``egm_unet_ab`` (base_c 32)
    converted by ``cli/convert.py`` and served: ``Predictor.from_checkpoint``
    at the serving bucket, batch 8, bf16, on both kernel routes, each
    forward's launches held to the route's counts; the egm_unet directory in
    float32 on the card against the CPU's plain versions (2 images,
    ``card_vs_cpu``'s bounds); ``cli/predict.py`` on it writing PNGs, which
    ``cli/evaluating_indicator.py`` scores on the card against synthetic
    ground truth, its confusion matrix equal to one counted here; one forward
    timed under ``utils.profiling``'s ``trace`` as a ``span``, read back from
    the span table."""
    raws = [synthetic_tp_sample(300 + i)[0] for i in range(BATCH)]
    launches, per_model = per_forward(), {}
    for name in CONVERT_MODELS:
        directory = conv["dirs"][name]
        check(saved_epochs(str(directory)) == [0], f"{directory}: epochs "
                                                   f"{saved_epochs(str(directory))}")
        for conv_impl, up_impl in CONVERT_ROUTES:
            pred = converted_predictor(directory, name, conv_impl, up_impl, "bfloat16", "cuda")
            want = dict(PER_FORWARD if conv_impl == "gemm" else PER_FORWARD_PAIR)
            if name != "egm_unet":  # the yuan layout has no MCALayer
                want["mca_fused"] = want["mca_gates"] = 0
            pred.predict(raws[:1])  # first call: the bucket's cuDNN plans
            torch.cuda.synchronize()
            reset_launch_counts()
            masks = pred.predict(raws)
            torch.cuda.synchronize()
            got = launch_counts()
            check(got == want, f"{name} {conv_impl}/{up_impl}: launches {got} != {want}")
            for k in launches:
                launches[k] += got[k]
            for raw, mask in zip(raws, masks):
                check(mask.shape == raw.shape[:2] and int(mask.max()) <= 1,
                      f"{name}: mask {mask.shape} for image {raw.shape}")
            x = bucket_batch(pred, raws)
            per_model[f"{name}/{conv_impl}/{up_impl}"] = {
                "launches_per_forward": got,
                "ms_per_batch": time_ms(lambda: pred.forward(x), reps=5, warm=1),
                "foreground_share": float(np.mean([m.mean() for m in masks]))}
            del pred
    for rec in per_model.values():
        rec["img_per_s"] = BATCH / rec["ms_per_batch"] * 1e3

    # float32: card (kernels) against the CPU (plain versions), 2 images
    directory = conv["dirs"]["egm_unet"]
    gpu_pred = converted_predictor(directory, "egm_unet", "gemm", "matmul", "float32", "cuda",
                                   batch=2)
    cpu_pred = converted_predictor(directory, "egm_unet", "gemm", "matmul", "float32", "cpu",
                                   batch=2)
    x = bucket_batch(gpu_pred, raws[:2])[:2].cpu()
    t0 = time.perf_counter()
    cpu = cpu_pred.model(x)["out"]
    cpu_s = time.perf_counter() - t0
    reset_launch_counts()
    gpu = gpu_pred.model(x.cuda())["out"].cpu()
    f32_launches = launch_counts()
    check(f32_launches == in_float32(PER_FORWARD),
          f"float32 converted forward launches {f32_launches}")
    card_vs_cpu_record("egm_unet_converted", list(x.shape), gpu, cpu, f32_launches,
                       masks=True, route=["gemm", "matmul"], cpu_s=cpu_s)
    del gpu_pred, cpu_pred

    # cli/predict.py on the directory, then the offline evaluator on the card
    eval_dir = OUT_DIR / "convert_eval"
    pred_dir, gt_dir = eval_dir / "pred", eval_dir / "gt"
    shutil.rmtree(eval_dir, ignore_errors=True)
    gt_dir.mkdir(parents=True)
    printed = io.StringIO()
    reset_launch_counts()
    with contextlib.redirect_stdout(printed):
        predict_cli.main(["--synthetic", "--amp", "--weights", str(directory),
                          "--base-c", str(BASE_C), "--save-result", str(pred_dir)])
    torch.cuda.synchronize()
    cli_launches = launch_counts()
    want = {k: v * 2 * N_EVAL_IMAGES for k, v in PER_FORWARD.items()}
    check(f"loaded weights from {directory}" in printed.getvalue(),
          f"predict CLI did not load {directory}: {printed.getvalue()[:300]}")
    check(cli_launches == want, f"predict CLI launches {cli_launches} != {want}")
    for k in launches:
        launches[k] += cli_launches[k]
    ds = SyntheticTPDataset(n=N_EVAL_IMAGES)
    names = [ds.names[i][-4:] for i in range(N_EVAL_IMAGES)]
    for i, name in enumerate(names):
        Image.fromarray((ds[i][1] * 255).astype(np.uint8)).save(gt_dir / f"{name}.png")
    (eval_dir / "val.txt").write_text("\n".join(names) + "\n")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        hist = evaluating_indicator.main([
            "--gt-dir", str(gt_dir), "--pred-dir", str(pred_dir),
            "--txt-dir", str(eval_dir / "val.txt"), "--log-path", str(eval_dir / "eval.log"),
            "--out-dir", str(eval_dir), "--device", "cuda"])
    eval_s = time.perf_counter() - t0
    ref = eval_confmat(gt_dir, pred_dir, names)
    check(np.array_equal(hist, ref), f"evaluator confusion {hist.tolist()} != {ref.tolist()}")
    rows = (eval_dir / "confusion_matrix.csv").read_text().splitlines()[1:]
    csv_hist = np.array([[int(v) for v in r.split(",")[1:]] for r in rows])
    check(np.array_equal(csv_hist, ref), f"confusion CSV {csv_hist.tolist()} != {ref.tolist()}")
    check(int(ref.sum()) == N_EVAL_IMAGES * 565 * 752, f"confusion total {int(ref.sum())}")

    # one forward as a span under trace
    pred = converted_predictor(directory, "egm_unet", "gemm", "matmul", "bfloat16", "cuda")
    x = bucket_batch(pred, raws)
    pred.forward(x)
    trace_dir = OUT_DIR / "convert_serve_trace"
    with trace(str(trace_dir)):
        with span("convert_serve.forward"):
            pred.forward(x)
            device_synchronized("cuda")
    text = (trace_dir / "trace.json").read_text()
    symbols = {"mca_fused": "mca_tile_kernel", "conv3x3_gemm": "conv3x3_mma_kernel",
               "up_concat_conv": "upconv_mma_kernel", "span": "convert_serve.forward"}
    missing = [k for k, sym in symbols.items() if sym not in text]
    check(not missing, f"trace.json names no {missing}")
    spans = table()
    check(spans.get("convert_serve.forward", {}).get("count") == 1
          and json.loads((trace_dir / "spans.json").read_text()) == spans,
          f"span table {spans}")
    del pred
    rec = {"phase": "convert_serve", "models": list(CONVERT_MODELS), "base_c": BASE_C,
           "convert_s": conv["seconds"], "convert_log": conv["logs"],
           "routes": per_model, "launches": launches, "predict_cli_launches": cli_launches,
           "eval_confmat": ref.tolist(), "eval_s": eval_s,
           "eval_miou": float(np.mean(np.diag(ref) / np.maximum(
               ref.sum(0) + ref.sum(1) - np.diag(ref), 1))),
           "forward_span_ms": spans["convert_serve.forward"]["seconds"] * 1e3,
           "trace_bytes": len(text), "card": dev["nvidia_smi"]}
    emit(rec)
    return rec


def phase_convert_clip(dev, conv: dict) -> dict:
    """The ``--kind clip --stretch-long`` output read back by
    ``load_converted_clip`` into the fusion phase's CLIPSeg (rd64 over
    ViT-B/16, batch 32 at 352 px, bf16): its logits bit-equal to the same
    forward on ``load_clip_checkpoint(.pt, stretch_to_long=True)``'s
    weights, K6's launches counted."""
    cfg, state = load_converted_clip(str(conv["clip_out"]))
    check(cfg == VIT_B16, f"converted CLIP config {cfg} != VIT_B16")
    _, direct = load_clip_checkpoint(str(conv["clip_pt"]), stretch_to_long=True)
    check(set(state) == set(direct) and all(torch.equal(state[k], direct[k]) for k in state),
          "the converted file's state differs from load_clip_checkpoint's")
    gen = torch.Generator().manual_seed(SEED + 2)
    x = torch.randn(CLIP_BATCH, CLIP_SIZE, CLIP_SIZE, 3, generator=gen).cuda()
    outs, counts = {}, {}
    for route, weights in (("converted", state), ("load_clip_checkpoint", direct)):
        # the same decoder (one seed) over each route's tower
        model = CLIPDensePredT(clip_cfg=cfg, reduce_dim=64, extract_layers=(3, 6, 9))
        init_weights(model, torch.Generator().manual_seed(SEED))
        model.clip.load_state_dict(weights)
        model = cast_weights(model.to("cuda"), torch.bfloat16).eval()
        conds = model.compute_conditional(prompt_tokens().cuda()).float().repeat(
            CLIP_BATCH // 2, 1)
        torch.cuda.synchronize()
        reset_launch_counts()
        (outs[route],) = model(x, conds)
        torch.cuda.synchronize()
        counts[route] = launch_counts()
        check(counts[route] == PER_CLIPSEG_FORWARD,
              f"{route} CLIPSeg launches {counts[route]} != {PER_CLIPSEG_FORWARD}")
        del model
    a, b = outs["converted"], outs["load_clip_checkpoint"]
    check(tuple(a.shape) == (CLIP_BATCH, CLIP_SIZE, CLIP_SIZE, 1)
          and bool(torch.isfinite(a).all()), f"converted CLIPSeg logits {tuple(a.shape)}")
    check(torch.equal(a, b), f"converted vs direct CLIPSeg logits differ by "
                             f"{(a - b).abs().max().item()}")
    rec = {"phase": "convert_clip", "config": dataclasses.asdict(cfg), "stretch_long": True,
           "tensors": len(state), "launches": counts["converted"], "logits_bit_equal": True,
           "clip_batch": CLIP_BATCH, "clip_size": CLIP_SIZE, "dtype": "bfloat16",
           "card": dev["nvidia_smi"]}
    emit(rec)
    del x, outs
    torch.cuda.empty_cache()
    return rec


def phase_vitseg(dev) -> None:
    """VITDensePredT at the published width (ViT-B/16 at 384, 12 layers, rd64,
    extract (3, 6, 9)) on seeded weights, float32 with TF32 off: card
    against CPU on 2 images at ``card_vs_cpu``'s bound, and a batch of 8
    timed on the card.  No hand-written kernel runs here."""
    model = VITDensePredT(extract_layers=(3, 6, 9), reduce_dim=64)
    init_weights(model, torch.Generator().manual_seed(SEED)).eval()
    gen = torch.Generator().manual_seed(SEED + 5)
    img = torch.randn(BATCH, 352, 352, 3, generator=gen)  # resized to 384 inside
    cond = torch.randn(BATCH, 512, generator=gen)
    t0 = time.perf_counter()
    (cpu,) = model(img[:2], cond[:2])
    cpu_s = time.perf_counter() - t0
    model = model.to("cuda")
    reset_launch_counts()
    (gpu,) = model(img[:2].cuda(), cond[:2].cuda())
    launches = launch_counts()
    check(not any(launches.values()), f"VITDensePredT launched {launches}")
    res = model.resolution
    check(tuple(gpu.shape) == (2, res, res, 1), f"VITDensePredT logits {tuple(gpu.shape)}")
    card_vs_cpu_record("vitseg", [2, 352, 352, 3], gpu.cpu(), cpu, launches, masks=False,
                       cpu_s=cpu_s)
    xb, cb = img.cuda(), cond.cuda()
    ms = time_ms(lambda: model(xb, cb), reps=5, warm=1)
    emit({"phase": "vitseg", "batch": BATCH, "resolution": res, "dtype": "float32",
          "tf32": False, "ms_per_batch": ms, "img_per_s": BATCH / ms * 1e3,
          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "card": dev["nvidia_smi"]})
    del model, xb, cb
    torch.cuda.empty_cache()


def phase_extra_modules(dev) -> None:
    """The reference's unwired modules (``nn/extra.py``) at C=64, 144x192,
    batch 8, float32, seeded weights: card against CPU at ``card_vs_cpu``'s
    bound each; HEGDC in eval mode on randomised running statistics."""
    gen = torch.Generator().manual_seed(SEED + 6)
    x = torch.randn(BATCH, 144, 192, 64, generator=gen)
    hegdc = init_weights(extra.HEGDC(64, 64), gen)
    for bn in (hegdc.bn1, hegdc.bn2):
        bn.mean.copy_(torch.randn(64, generator=gen) * 0.3)
        bn.var.copy_(0.5 + 1.5 * torch.rand(64, generator=gen))
    cases = {"ELA": init_weights(extra.ELA(64), gen).eval(),
             "WConv2d": init_weights(extra.WConv2d(64, 64), gen).eval(),
             "HEGDC": hegdc.eval(),
             "scharr_conv": extra.scharr_conv, "sobel_conv": extra.sobel_conv,
             "soft_pooling_2d": extra.soft_pooling_2d}
    times = {}
    for name, fn in cases.items():
        cpu = fn(x)
        if isinstance(fn, torch.nn.Module):
            fn = fn.to("cuda")
        xc = x.cuda()
        gpu = fn(xc)
        card_vs_cpu_record(f"extra_{name}", list(x.shape), gpu.float().cpu(), cpu.float(),
                           launch_counts(), masks=False)
        times[name] = time_ms(lambda: fn(xc), reps=5, warm=1)
    emit({"phase": "extra_modules", "shape": list(x.shape), "dtype": "float32",
          "ms": times, "card": dev["nvidia_smi"]})


def synthetic_merges(n: int = 3000, seed: int = SEED):
    """A seeded BPE merge list over a-z: each merge joins two symbols made
    so far, the right one a word end (``</w>``) a third of the time.
    Returns the merges and the symbols they made (inner, word ends)."""
    rng = np.random.default_rng(seed)
    inner = list("abcdefghijklmnopqrstuvwxyz")
    ends = [c + "</w>" for c in inner]
    merges, seen = [], set()
    while len(merges) < n:
        a = inner[rng.integers(len(inner))]
        end = rng.random() < 1 / 3
        b = (ends if end else inner)[rng.integers(len(ends) if end else len(inner))]
        if (a, b) in seen or len(a) + len(b) > 16:
            continue
        seen.add((a, b))
        merges.append((a, b))
        (ends if end else inner).append(a + b)
    return merges, inner, ends


def phase_native_bpe(dev) -> None:
    """The native BPE merge loop built on this machine (``g++``, into the
    build directory) against the Python loop on 128 seeded prompts of 60
    words (Long-CLIP's 248-token context, truncated), each word one to three
    merged symbols and a merged word end, so that the merges apply: equal
    ids, and each loop's prompts per second on a fresh tokenizer (host
    clock)."""
    merges, inner, ends = synthetic_merges()
    rng = np.random.default_rng(SEED + 7)

    def word():
        parts = [inner[i] for i in rng.integers(0, len(inner), int(rng.integers(1, 4)))]
        return "".join(parts) + ends[rng.integers(len(ends))][:-len("</w>")]

    texts = [" ".join(word() for _ in range(60)) for _ in range(128)]
    t0 = time.perf_counter()
    native.build_library("bpe")
    build_s = time.perf_counter() - t0
    ids, rates = {}, {}
    for loop in ("python", "native"):
        tok = SimpleTokenizer(merges=merges, native=loop == "native")
        check(tok.merge_loop == loop, f"tokenizer runs {tok.merge_loop}, not {loop}")
        t0 = time.perf_counter()
        ids[loop] = tokenize(texts, truncate=True, tokenizer=tok)
        rates[loop] = len(texts) / (time.perf_counter() - t0)
    check(np.array_equal(ids["native"], ids["python"]), "native BPE ids differ from Python's")
    merged = int((ids["python"] > 511).sum())  # ids past the byte symbols: merges applied
    check(merged > 0, "the synthetic merges merged nothing")
    emit({"phase": "native_bpe", "prompts": len(texts), "merges": len(merges),
          "build_s": build_s, "prompts_per_s": rates,
          "native_over_python": rates["native"] / rates["python"],
          "merged_tokens": merged, "ids_equal": True, "host": dev["nvidia_smi"]})


def summary(records, main_paths: dict) -> list:
    """Per kernel: times summed over one forward's launches at the path shape
    (each shape's time times its sites per forward): ``ms`` with the host's
    launch work (``time_ms``), ``device_ms`` without it (``device_time_ms``),
    and the library yardstick both ways (``library_ms``,
    ``library_device_ms``);
    launches from the main-path runs ``main_paths`` (phase -> its launch
    counts), whose counts were reset just before each."""
    fwd = f"batch {BATCH}, {BUCKET[0]}x{BUCKET[1]}, bf16"
    per = {name: f"one EGM-UNet forward, {fwd}" for name in SOURCES}
    for name in ("conv3x3_pair_gemm", "upsample2x_fused"):
        per[name] = f"one EGM-UNet forward on the pair / fused-upsample route, {fwd}"
    per["csa_attention"] = (f"one CLIPSeg forward, batch {CLIP_BATCH}, "
                            f"{CSA_PATH_SHAPE[1]} tokens, bf16")
    out = []
    for name in SOURCES:
        mine = [r for r in records if r["name"] == name and r.get("phase") == "kernel"]
        path = [r for r in mine if "sites_per_forward" in r]
        per_fwd = lambda key: sum(r[key] * r["sites_per_forward"] for r in path)
        t_bytes = sum(r["bound_ms"] * r["sites_per_forward"] for r in path
                      if r["bound_by"] == "bytes")
        launches = sum(counts[name] for counts in main_paths.values())
        check(launches > 0, f"{name} was not launched on a main path")
        out.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches,
            **{f"launches_{phase}": counts[name] for phase, counts in main_paths.items()},
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": per_fwd("kernel_ms"), "device_ms": per_fwd("device_ms"),
            "plain_ms": per_fwd("plain_ms"),
            "bound_ms": per_fwd("bound_ms"),
            "bound_by": "bytes" if t_bytes >= per_fwd("bound_ms") / 2 else "operations",
            "library_ms": None if path[0]["library_ms"] is None else per_fwd("library_ms"),
            "library_device_ms": (None if path[0]["library_device_ms"] is None
                                  else per_fwd("library_device_ms")),
            "per": per[name], "shapes": len(path),
            **({"variant": path[0]["variant"]} if "variant" in path[0] else {}),
            **(text_paths(records) if name == "csa_attention" else {})})
    return out


def text_paths(records) -> dict:
    """K6 in float32, one launch each, on the paths that run it (the fusion
    CLIs' CLIPSeg forward and the text branch's two trainers), and the
    closed-form backward's times."""
    keys = ("site", "shape", "variant", "tile", "max_abs_err", "kernel_ms", "device_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "library_device_ms")
    f32 = [{k: r[k] for k in keys} for r in records if r.get("phase") == "kernel"
           and r["name"] == "csa_attention" and r["dtype"] == "float32"]
    backward = [{k: r[k] for k in ("shape", "dtype", "ms", "plain_autograd_ms")}
                for r in records if r.get("phase") == "csa_backward"]
    return {"float32_paths": f32, "backward": backward}


def main() -> None:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_records.jsonl").unlink(missing_ok=True)
    t0 = time.perf_counter()
    seconds = {}

    def mark(group: str) -> None:  # command seconds per group of phases
        seconds[group] = time.perf_counter() - t0 - sum(seconds.values())

    dev = phase_device()
    phase_build()
    mark("build")
    # serving: no autograd, as every serving entry point runs
    with torch.inference_mode():
        pred = make_predictor()
        httpd, batcher = make_pair_server()
        images = [synthetic_tp_sample(i)[0] for i in range(BATCH)]
        records = phase_kernels(pred, batcher.predictor, images)
        phase_edges()
        phase_gates()
        phase_eafe()
        phase_conv1x1(pred, images, records)
        main_paths = {"serving": phase_serving(pred, dev)["launches"],
                      "fusion": phase_fusion(pred.model, dev)["launches"],
                      "clipseg_f32": phase_clipseg_f32(dev),
                      "serve": phase_serve(httpd, batcher, pred, dev)["launches"],
                      "predict_cli": phase_predict_cli(dev)["launches"]}
        phase_card_vs_cpu()
    del pred, httpd, batcher
    torch.cuda.empty_cache()
    mark("serving_fusion")
    # reference checkpoints converted and served; the rest of the tail
    with torch.inference_mode(), tempfile.TemporaryDirectory() as work:
        conv = convert_all(Path(work))
        main_paths["convert_serve"] = phase_convert_serve(dev, conv)["launches"]
        main_paths["convert_clip"] = phase_convert_clip(dev, conv)["launches"]
    with torch.inference_mode():
        phase_vitseg(dev)
        phase_extra_modules(dev)
    phase_native_bpe(dev)
    torch.cuda.empty_cache()
    mark("convert_tail")
    # training: autograd on, the BatchNorm graph, no hand-written kernel
    phase_guard()
    main_paths["train"] = phase_train(dev)
    main_paths["train_cli"], main_paths["train_cli_serve"], trained = phase_train_cli(dev)
    phase_train_card_vs_cpu()
    mark("training")
    # the GPU-resident training set
    phase_device_aug_card_vs_cpu()
    main_paths["train_device_cache"] = phase_train_device_cache(dev)
    torch.cuda.empty_cache()
    mark("device_cache")
    # int8 serving
    with torch.inference_mode():
        main_paths["quant"] = phase_quant(dev, trained)
        main_paths["serve_quant"] = phase_serve_quant(dev)
    torch.cuda.empty_cache()
    mark("quant")
    # the text branch's training: float32, TF32 off, as the JAX CLIs' default
    text_kernel_records(records)
    main_paths["train_clipseg"] = phase_train_clipseg(dev)
    main_paths["train_longclip"] = phase_train_longclip(dev)
    phase_text_train_card_vs_cpu()
    main_paths["clip_resnet"] = phase_clip_resnet(dev)
    mark("text_branch")
    # SegFormer-B5 served in bf16
    with torch.inference_mode():
        main_paths["segformer"] = phase_segformer(dev)
    mark("segformer")
    # data parallel: NCCL groups of one, and two ranks sharing the card over gloo
    main_paths["dp_train"] = launch(dp_train_world1, 1, "nccl", dev)[0]
    two_ranks = phase_dp_two_ranks_card(dev)
    main_paths["dp_longclip"] = launch(dp_longclip_world1, 1, "nccl", dev, two_ranks)[0]
    mark("data_parallel")
    # spatial and tensor parallel: ranks sharing the card over gloo
    phase_sp_card(dev)
    phase_dp_sp_card(dev)
    main_paths["tp_card"] = phase_tp_card(dev, records)
    phase_dp_tp_card(dev)
    mark("spatial_tensor")
    kernels = summary(records, main_paths)
    emit({"phase": "seconds", **seconds, "total": time.perf_counter() - t0})
    print(dev["nvidia_smi"])
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})


if __name__ == "__main__":
    main()
