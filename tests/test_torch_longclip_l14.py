"""Long-CLIP-L (``LONGCLIP_L14``) in egm_unet_torch, on the CPU.

- The preset's state dict, on the meta device, against the published
  shapes (ViT-L/14 at 224 px: 24 blocks of width 1024; the text tower: 12
  blocks of width 768 over 248 positions, two positional tables;
  ``embed_dim`` 768, vocabulary 49408) and its parameter count.
- The port's train step (``make_longclip_train_step``) against the plain float32 reference of the benchmark
  (``port_bench/reference/longclip.py``) at a tiny L/14-shaped size: patch
  14, heads of 64, ``embed_dim`` 64, batch 40 (the PCA keeps 32 of 39
  centred components), seeded random weights.  The first step's loss within
  1e-5 relative and each leaf's gradient, kept before the update, within
  1e-4 relative rms (float32 in a different order of operations: the CSA
  block, the fused projections and the SVD's gradient, whose terms scale
  with 1 / (sigma_32^2 - sigma_33^2), read about 1e-6 here).
- The reference's AdamW and schedule (the benchmark's check of the
  update) against the port's optimizer and ``longclip_schedule``: the same
  gradients give the same leaves after two steps, the second at a rate
  where weight decay shows; the rates agree over warm-up and cosine.
- The reference imports neither the port nor JAX.
- The step's spans and counters under ``recording()``.
- ``cli/train_longclip.py --clip-config``: the preset built without a
  checkpoint; ``--tiny-clip`` and a checkpoint still win.
"""

import ast
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from egm_unet_torch.cli import train_longclip
from egm_unet_torch.cli.eval_clipseg import tiny_clip_config
from egm_unet_torch.engine.longclip_train import (create_longclip_state,
                                                  make_longclip_train_step)
from egm_unet_torch.models.clip import model as clip_model
from egm_unet_torch.models.clip.model import CLIP, LONGCLIP_L14, VIT_B16, CLIPConfig
from egm_unet_torch.utils import profiling
from port_bench.reference import longclip as ref_longclip
from port_bench.weights import make_weights, shapes_of

from tests.torch_train_util import one_thread

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(embed_dim=64, resolution=42, vision_layers=2, vision_width=128, patch=14,
            context=24, vocab=512, text_width=64, text_heads=1, text_layers=2)
TINY_CFG = CLIPConfig(embed_dim=64, image_resolution=42, vision_layers=2, vision_width=128,
                      vision_patch_size=14, context_length=24, vocab_size=512,
                      transformer_width=64, transformer_heads=1, transformer_layers=2)
BATCH = 40


@pytest.fixture(autouse=True)
def _grad_on():
    with one_thread():
        yield


def published_shapes() -> dict:
    """Long-CLIP-L's leaves in the port's names, kernels [in, out]."""
    out = {"visual.conv1.kernel": (14, 14, 3, 1024), "visual.class_embedding": (1024,),
           "visual.positional_embedding": (257, 1024), "visual.proj": (1024, 768),
           "token_embedding.embedding": (49408, 768), "positional_embedding": (248, 768),
           "positional_embedding_res": (248, 768), "text_projection": (768, 768),
           "logit_scale": ()}
    for ln, w in (("visual.ln_pre", 1024), ("visual.ln_post", 1024), ("ln_final", 768)):
        out[f"{ln}.scale"] = out[f"{ln}.bias"] = (w,)
    for prefix, n, w in (("visual.resblock", 24, 1024), ("text_resblock", 12, 768)):
        for i in range(n):
            b = f"{prefix}{i}."
            for ln in ("ln_1", "ln_2"):
                out[b + ln + ".scale"] = out[b + ln + ".bias"] = (w,)
            for name, cin, cout in (("in_proj", w, 3 * w), ("out_proj", w, w),
                                    ("c_fc", w, 4 * w), ("c_proj", 4 * w, w)):
                out[b + name + ".kernel"] = (cin, cout)
                out[b + name + ".bias"] = (cout,)
    return out


def test_preset_has_the_published_shapes_and_parameter_count():
    with torch.device("meta"):
        model = CLIP(LONGCLIP_L14)
    assert shapes_of(model) == published_shapes()
    assert model.cfg.vision_heads == 16 and model.cfg.transformer_heads == 12
    n = sum(p.numel() for p in model.parameters())
    # OpenAI's ViT-L/14 CLIP (427,616,513) with 248 text positions in two tables
    assert n == 427_616_513 + (248 - 77) * 768 + 248 * 768 == 427_938_305
    assert clip_model.PRESETS["longclip_l14"] is LONGCLIP_L14


def triples(seed: int):
    g = torch.Generator().manual_seed(seed)
    img = torch.randn(BATCH, 42, 42, 3, generator=g)
    ids = []
    for lo, hi in ((12, 25), (3, 9)):
        t = torch.randint(1, 510, (BATCH, 24), generator=g)
        n = torch.randint(lo, hi, (BATCH,), generator=g)
        t[torch.arange(24)[None] >= n[:, None]] = 0
        t[:, 0] = 510
        t[torch.arange(BATCH), n - 1] = 511
        ids.append(t)
    return img, ids[0], ids[1]


def first_step(model, batch):
    """The port's loss and gradients of one step, kept before the update."""
    state = create_longclip_state(model)
    kept = {}

    def keep(opt, args, kwargs):
        kept.update({n: p.grad.clone() for n, p in model.named_parameters()
                     if p.grad is not None})

    state.optimizer.register_step_pre_hook(keep)
    _, aux = make_longclip_train_step()(state, *batch)
    return float(aux["loss"]), kept


@pytest.mark.parametrize("seed", [3, 11, 2 ** 31 + 5, 2 ** 33 + 7])
def test_step_matches_the_plain_reference(seed):
    ref = ref_longclip.build(**TINY)
    port = CLIP(TINY_CFG)
    assert shapes_of(ref) == shapes_of(port)
    sd = make_weights(shapes_of(ref), seed, "cpu")
    ref.load_state_dict(sd)
    port.load_state_dict(sd)
    batch = triples(seed)
    loss, grads = first_step(port, batch)
    ref_loss, ref_grads, sv = ref_longclip.loss_and_grads(ref, *batch, block=16)
    assert sv[31] > sv[32] > 0  # the PCA drops components
    assert loss == pytest.approx(ref_loss, rel=1e-5)
    assert set(grads) == set(ref_grads) - {"positional_embedding"}
    for name, g in grads.items():
        r = ref_grads[name]
        assert float((g - r).norm()) <= 1e-4 * float(r.norm()), name


@pytest.mark.parametrize("step", [0, 1, 3, 4, 7, 10, 25])
def test_reference_schedule_is_the_ports(step):
    from egm_unet_torch.engine.longclip_train import longclip_schedule

    port = longclip_schedule(1e-3, warmup_steps=4, total_steps=10)(step)
    assert ref_longclip.schedule(step, 1e-3, 4, 10) == pytest.approx(port, rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("seed", [7, 2 ** 32 + 9])
def test_reference_adamw_is_the_ports_update(seed):
    port = CLIP(TINY_CFG)
    sd = make_weights(shapes_of(port), seed, "cpu")
    port.load_state_dict(sd)
    state = create_longclip_state(port, lr=1e-3, weight_decay=1e-2, warmup_steps=1,
                                  total_steps=10)
    kept = []

    def keep(opt, args, kwargs):
        kept.append({n: p.grad.clone() for n, p in port.named_parameters()
                     if p.grad is not None})

    state.optimizer.register_step_pre_hook(keep)
    step = make_longclip_train_step()
    for k in range(2):
        state, _ = step(state, *triples(seed + k))
    params = {n: v.clone() for n, v in sd.items() if n != "positional_embedding"}
    opt = ref_longclip.AdamW(params, 1e-2)
    for k, grads in enumerate(kept):
        opt.step(grads, ref_longclip.schedule(k, 1e-3, 1, 10))
    got = {n: p.detach() for n, p in port.named_parameters()}
    assert set(params) == set(kept[0])
    for name, p in params.items():  # moved by up to 1e-3 an element; equal to two roundings
        assert float(opt.moved[name].norm()) > 0, name
        torch.testing.assert_close(got[name], p, rtol=2.5e-7, atol=1e-9, msg=name)
    assert torch.equal(got["positional_embedding"], sd["positional_embedding"])


def test_reference_imports_neither_the_port_nor_jax():
    path = ROOT / "port_bench" / "reference" / "longclip.py"
    forbidden = ("egm_unet_torch", "egm_unet_tpu", "jax", "jaxlib", "flax", "optax")
    for node in ast.walk(ast.parse(path.read_text())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                 [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        assert not [n for n in names if n.split(".", 1)[0] in forbidden]
    out = subprocess.run(
        [sys.executable, "-c", "import json, sys; sys.path.insert(0, '.');"
         "import port_bench.reference.longclip; print(json.dumps(sorted(sys.modules)))"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert not [m for m in loaded if m.split(".", 1)[0] in forbidden]


SPANS = ("longclip.step", "longclip.encode_image", "longclip.encode_text", "longclip.loss",
         "longclip.backward", "longclip.update")


def test_step_records_its_spans_and_counters():
    model = CLIP(TINY_CFG)
    model.load_state_dict(make_weights(shapes_of(model), 5, "cpu"))
    state = create_longclip_state(model)
    step = make_longclip_train_step()
    batch = triples(5)
    profiling.reset_table()
    state, _ = step(state, *batch)
    assert profiling.table() == {}
    try:
        with profiling.recording():
            for _ in range(2):
                state, _ = step(state, *batch)
        tab = profiling.table()
    finally:
        profiling.reset_table()
    assert set(tab) == set(SPANS) | {"longclip.steps", "longclip.images"}
    assert {s: tab[s]["count"] for s in SPANS} == {
        "longclip.step": 2, "longclip.encode_image": 2, "longclip.encode_text": 4,
        "longclip.loss": 2, "longclip.backward": 2, "longclip.update": 2}
    assert tab["longclip.step"]["parent"] is None
    assert all(tab[s]["parent"] == "longclip.step" for s in SPANS[1:])
    assert tab["longclip.steps"]["value"] == 2 and tab["longclip.images"]["value"] == 2 * BATCH
    children = sum(tab[s]["seconds"] for s in SPANS[1:])
    assert tab["longclip.step"]["self_seconds"] == pytest.approx(
        tab["longclip.step"]["seconds"] - children)


class _Built(Exception):
    pass


@pytest.fixture
def built(monkeypatch):
    """The config ``fine_tune`` builds its CLIP from; stops it there."""
    seen = []

    def fake_clip(cfg):
        seen.append(cfg)
        raise _Built

    monkeypatch.setattr(clip_model, "CLIP", fake_clip)
    return seen


def _config(built, tmp_path, *flags):
    with pytest.raises(_Built):
        train_longclip.main(["--synthetic", "--device", "cpu", "--steps", "1",
                             "--clip-weights", str(tmp_path / "absent.pt"),
                             "--save-dir", str(tmp_path / "s"), *flags])
    return built[-1]


def test_cli_clip_config_builds_the_preset(built, tmp_path):
    assert _config(built, tmp_path, "--clip-config", "longclip_l14") == LONGCLIP_L14
    assert _config(built, tmp_path) == VIT_B16
    tiny = _config(built, tmp_path, "--clip-config", "longclip_l14", "--tiny-clip")
    assert tiny == tiny_clip_config(64)
    with pytest.raises(SystemExit):
        train_longclip.parse_args(["--clip-config", "vit_l14"])


def test_cli_checkpoint_wins_over_the_preset(built, tmp_path, monkeypatch):
    from egm_unet_torch.utils import convert

    ckpt = tmp_path / "longclip.pt"
    ckpt.write_bytes(b"")
    small = dataclasses.asdict(TINY_CFG)
    monkeypatch.setattr(convert, "load_clip_checkpoint", lambda path, stretch_to_long: (small, {}))
    with pytest.raises(_Built):
        train_longclip.main(["--synthetic", "--device", "cpu", "--steps", "1",
                             "--clip-config", "longclip_l14", "--clip-weights", str(ckpt),
                             "--save-dir", str(tmp_path / "s")])
    assert built[-1] == TINY_CFG
