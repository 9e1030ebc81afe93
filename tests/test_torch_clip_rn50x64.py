"""CLIP RN50x64 (``RN50X64``) through the Long-CLIP fine-tune, on the CPU.

- The preset's state dict, on the meta device, against the published
  shapes (the ModifiedResNet at 448 px: Bottlenecks (3, 15, 36, 10) at
  width 128, an attention pool of 64 heads over 14^2 + 1 tokens of width
  4096; the text tower: 12 blocks of width 1024 over 248 positions in two
  tables; ``embed_dim`` 1024) and its parameter count.
- The port's train step against the plain float32 reference of the
  benchmark (``port_bench/reference/clip_resnet.py``; the JAX package's
  fine-tune trains the BatchNorm statistics, this one does not) at a tiny
  RN-shaped size, stages (1, 2, 1, 1) at width 16, 64 px, batch 40 (the PCA
  keeps 32 of 39 centred components): the first step's loss within 1e-5
  relative and each leaf's gradient within 1e-4 relative rms (float32 in
  another order: NHWC convolutions, the attention pool's every query, the
  SVD's gradient); the reference's AdamW on the port's gradients gives the
  port's leaves after two steps; the BatchNorm statistics stay as loaded,
  bit for bit.
- Recomputation (both towers' blocks): gradients with and without it equal
  bit for bit; the recompute span and counter under ``recording()``.
- An OpenAI-format RN state dict stretched by ``load_clip_checkpoint``
  builds a tower the step trains; a checkpoint with RN50x64's widths takes
  the preset's settings in ``cli/train_longclip.py``.
- The ViT presets' optimizer keeps the leaves it had.
"""

import dataclasses

import numpy as np
import pytest
import torch

from egm_unet_torch.cli import train_longclip
from egm_unet_torch.engine.longclip_train import (create_longclip_state, frozen_names,
                                                  make_longclip_train_step)
from egm_unet_torch.models.clip import model as clip_model
from egm_unet_torch.models.clip.model import (CLIP, LONGCLIP_L14, RN50X64, VIT_B16,
                                              CLIPConfig, preset_of)
from egm_unet_torch.utils import convert, profiling
from port_bench.reference import clip_resnet as ref_rn
from port_bench.reference import longclip as ref_longclip
from port_bench.weights import make_weights, shapes_of

from tests.torch_train_util import one_thread

LAYERS, WIDTH = (1, 2, 1, 1), 16
TINY = dict(embed_dim=64, resolution=64, vision_layers=LAYERS, vision_width=WIDTH, context=24,
            vocab=512, text_width=64, text_heads=1, text_layers=2)
TINY_CFG = CLIPConfig(embed_dim=64, image_resolution=64, vision_layers=LAYERS,
                      vision_width=WIDTH, vision_patch_size=0, context_length=24,
                      vocab_size=512, transformer_width=64, transformer_heads=1,
                      transformer_layers=2, long_clip=True)
BATCH = 40
NULL_GRAD = "visual.attnpool.k_proj.bias"  # every key shifted alike: gradient 0


@pytest.fixture(autouse=True)
def _grad_on():
    with one_thread():
        yield


def rn_shapes(layers, w, embed, res, tw, ctx, vocab, text_layers) -> dict:
    """A ModifiedResNet CLIP's leaves in the port's names (kernels HWIO and
    [in, out]), written from clip/model.py's description."""
    out = {}

    def conv(name, k, cin, cout):
        out[f"visual.{name}.kernel"] = (k, k, cin, cout)

    def bn(name, c):
        for leaf in ("scale", "bias", "mean", "var"):
            out[f"visual.{name}.{leaf}"] = (c,)

    for i, (cin, cout) in enumerate([(3, w // 2), (w // 2, w // 2), (w // 2, w)], start=1):
        conv(f"stem_conv{i}", 3, cin, cout)
        bn(f"stem_bn{i}", cout)
    inplanes = w
    for s, n in enumerate(layers, start=1):
        planes = w * 2 ** (s - 1)
        for b in range(n):
            p = f"layer{s}_{b}"
            for j, (k, cin, cout) in enumerate([(1, inplanes, planes), (3, planes, planes),
                                                (1, planes, 4 * planes)], start=1):
                conv(f"{p}.conv{j}", k, cin, cout)
                bn(f"{p}.bn{j}", cout)
            if b == 0:  # the stride or the width changes
                conv(f"{p}.ds_conv", 1, inplanes, 4 * planes)
                bn(f"{p}.ds_bn", 4 * planes)
            inplanes = 4 * planes
    d = 32 * w
    out["visual.attnpool.positional_embedding"] = ((res // 32) ** 2 + 1, d)
    for name, cout in (("q_proj", d), ("k_proj", d), ("v_proj", d), ("c_proj", embed)):
        out[f"visual.attnpool.{name}.kernel"] = (d, cout)
        out[f"visual.attnpool.{name}.bias"] = (cout,)
    out.update({"token_embedding.embedding": (vocab, tw), "positional_embedding": (ctx, tw),
                "positional_embedding_res": (ctx, tw), "text_projection": (tw, embed),
                "logit_scale": (), "ln_final.scale": (tw,), "ln_final.bias": (tw,)})
    for i in range(text_layers):
        b = f"text_resblock{i}."
        for ln in ("ln_1", "ln_2"):
            out[b + ln + ".scale"] = out[b + ln + ".bias"] = (tw,)
        for name, cin, cout in (("in_proj", tw, 3 * tw), ("out_proj", tw, tw),
                                ("c_fc", tw, 4 * tw), ("c_proj", 4 * tw, tw)):
            out[b + name + ".kernel"] = (cin, cout)
            out[b + name + ".bias"] = (cout,)
    return out


def test_preset_has_the_published_shapes_and_parameter_count():
    with torch.device("meta"):
        model = CLIP(RN50X64)
    assert shapes_of(model) == rn_shapes((3, 15, 36, 10), 128, 1024, 448, 1024, 248, 49408, 12)
    assert model.visual.attnpool.num_heads == 64 and model.visual.recompute
    assert clip_model.PRESETS["rn50x64"] is RN50X64
    n = sum(p.numel() for p in model.parameters())
    stats = sum(p.numel() for k, p in model.named_parameters() if k.endswith((".mean", ".var")))
    with torch.device("meta"):
        n77 = sum(p.numel() for p in CLIP(dataclasses.replace(
            RN50X64, context_length=77, long_clip=False)).parameters())
    # open_clip's RN50x64 (623.26M) keeps the 410,624 BatchNorm statistics as buffers
    assert stats == 410_624 and n77 - stats == 623_258_305
    assert n == n77 + (248 - 77) * 1024 + 248 * 1024 == 624_097_985


def triples(seed: int, res: int = 64, ctx: int = 24, vocab: int = 512):
    g = torch.Generator().manual_seed(seed)
    img = torch.randn(BATCH, res, res, 3, generator=g)
    ids = []
    for lo, hi in ((12, ctx + 1), (3, 9)):
        t = torch.randint(1, vocab - 2, (BATCH, ctx), generator=g)
        n = torch.randint(lo, hi, (BATCH,), generator=g)
        t[torch.arange(ctx)[None] >= n[:, None]] = 0
        t[:, 0] = vocab - 2
        t[torch.arange(BATCH), n - 1] = vocab - 1
        ids.append(t)
    return img, ids[0], ids[1]


def port_steps(model, batches, **kw):
    """Steps of the port; every step's gradients and loss, kept before the
    update."""
    state = create_longclip_state(model, **kw)
    kept = []

    def keep(opt, args, kwargs):
        kept.append({n: p.grad.clone() for n, p in model.named_parameters()
                     if p.grad is not None})

    state.optimizer.register_step_pre_hook(keep)
    step = make_longclip_train_step()
    losses = []
    for b in batches:
        state, aux = step(state, *b)
        losses.append(float(aux["loss"]))
    return losses, kept, state


def seeded(seed):
    ref = ref_rn.build(**TINY)
    port = CLIP(TINY_CFG)
    assert shapes_of(ref) == shapes_of(port)
    sd = make_weights(shapes_of(ref), seed, "cpu")
    ref.load_state_dict(sd)
    port.load_state_dict(sd)
    return ref, port, sd


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5])
def test_two_steps_match_the_plain_reference(seed):
    ref, port, sd = seeded(seed)
    batches = [triples(seed), triples(seed + 1)]
    losses, kept, state = port_steps(port, batches, lr=1e-3, weight_decay=1e-2,
                                     warmup_steps=1, total_steps=10)
    ref_loss, ref_grads, sv = ref_longclip.loss_and_grads(ref, *batches[0], block=16)
    assert sv[31] > sv[32] > 0  # the PCA drops components
    assert losses[0] == pytest.approx(ref_loss, rel=1e-5)
    stats = {n for n, _ in ref.named_buffers()}
    assert stats and stats <= frozen_names(port)
    trained = set(ref_grads) - {"positional_embedding"}
    assert set(kept[0]) == trained and not stats & set(kept[0])
    for name, g in kept[0].items():
        r = ref_grads[name]
        if name == NULL_GRAD:  # rounding on both sides, next to the kernel's
            scale = float(ref_grads["visual.attnpool.k_proj.kernel"].norm())
            assert float(g.norm()) <= 1e-5 * scale and float(r.norm()) <= 1e-5 * scale
            continue
        assert float((g - r).norm()) <= 1e-4 * float(r.norm()), name
    # the reference's AdamW on the port's gradients: the port's leaves
    params = {n: sd[n].clone() for n in trained}
    opt = ref_longclip.AdamW(params, 1e-2)
    for k, grads in enumerate(kept):
        opt.step(grads, ref_longclip.schedule(k, 1e-3, 1, 10))
    got = {n: p.detach() for n, p in port.named_parameters()}
    for name, p in params.items():
        assert float(opt.moved[name].norm()) > 0, name
        torch.testing.assert_close(got[name], p, rtol=2.5e-7, atol=1e-9, msg=name)
    for name in stats | {"positional_embedding"}:  # as loaded, bit for bit
        assert torch.equal(got[name], sd[name]), name
    assert not {id(p) for g in state.optimizer.param_groups for p in g["params"]} & {
        id(p) for n, p in port.named_parameters() if n in stats}


def test_recompute_gives_the_same_gradients_bit_for_bit():
    _, plain, sd = seeded(7)
    again = CLIP(dataclasses.replace(TINY_CFG, recompute=True))
    again.load_state_dict(sd)
    batch = [triples(7)]
    loss, grads, _ = port_steps(plain, batch)
    profiling.reset_table()
    try:
        with profiling.recording():
            loss_r, grads_r, _ = port_steps(again, batch)
        tab = profiling.table()
    finally:
        profiling.reset_table()
    assert loss == loss_r
    assert set(grads[0]) == set(grads_r[0])
    for name, g in grads[0].items():
        assert torch.equal(g, grads_r[0][name]), name
    # 5 Bottlenecks, and 2 text blocks for each of the 2 captions
    assert tab["longclip.recomputed_blocks"]["value"] == 9
    assert tab["longclip.recompute"]["count"] == 9
    assert tab["longclip.recompute"]["parent"] == "longclip.backward"
    with torch.no_grad():  # nothing to recompute: a plain forward
        img, ids = batch[0][0][:2], batch[0][1][:2]
        assert torch.equal(again.encode_image(img), plain.encode_image(img))
        assert torch.equal(again.encode_text(ids), plain.encode_text(ids))


def openai_rn_state_dict(make, layers, w, embed, res, tw, ctx, vocab, text_layers) -> dict:
    """An OpenAI-format ModifiedResNet CLIP state dict (module names of
    clip/model.py), each tensor ``make(shape, kind)``."""
    sd = {}

    def bn(name, c):
        for leaf, kind in (("weight", "bn_weight"), ("bias", "bias"), ("running_mean", "mean"),
                           ("running_var", "var")):
            sd[f"{name}.{leaf}"] = make((c,), kind)

    def linear(name, cout, cin):
        sd[f"{name}.weight"] = make((cout, cin), "linear")
        sd[f"{name}.bias"] = make((cout,), "bias")

    for i, (cin, cout) in enumerate([(3, w // 2), (w // 2, w // 2), (w // 2, w)], start=1):
        sd[f"visual.conv{i}.weight"] = make((cout, cin, 3, 3), "conv")
        bn(f"visual.bn{i}", cout)
    inplanes = w
    for s, n in enumerate(layers, start=1):
        planes = w * 2 ** (s - 1)
        for b in range(n):
            p = f"visual.layer{s}.{b}"
            for j, (k, cin, cout) in enumerate([(1, inplanes, planes), (3, planes, planes),
                                                (1, planes, 4 * planes)], start=1):
                sd[f"{p}.conv{j}.weight"] = make((cout, cin, k, k), "conv")
                bn(f"{p}.bn{j}", cout)
            if b == 0:
                sd[f"{p}.downsample.0.weight"] = make((4 * planes, inplanes, 1, 1), "conv")
                bn(f"{p}.downsample.1", 4 * planes)
            inplanes = 4 * planes
    d = 32 * w
    sd["visual.attnpool.positional_embedding"] = make(((res // 32) ** 2 + 1, d), "pos")
    for name, cout in (("q_proj", d), ("k_proj", d), ("v_proj", d), ("c_proj", embed)):
        linear(f"visual.attnpool.{name}", cout, d)
    sd["token_embedding.weight"] = make((vocab, tw), "pos")
    sd["positional_embedding"] = make((ctx, tw), "pos")
    sd["text_projection"] = make((tw, embed), "pos")
    sd["logit_scale"] = make((), "logit_scale")
    sd["ln_final.weight"], sd["ln_final.bias"] = make((tw,), "bn_weight"), make((tw,), "bias")
    for i in range(text_layers):
        p = f"transformer.resblocks.{i}"
        sd[f"{p}.attn.in_proj_weight"] = make((3 * tw, tw), "linear")
        sd[f"{p}.attn.in_proj_bias"] = make((3 * tw,), "bias")
        linear(f"{p}.attn.out_proj", tw, tw)
        linear(f"{p}.mlp.c_fc", 4 * tw, tw)
        linear(f"{p}.mlp.c_proj", tw, 4 * tw)
        for ln in ("ln_1", "ln_2"):
            sd[f"{p}.{ln}.weight"], sd[f"{p}.{ln}.bias"] = (make((tw,), "bn_weight"),
                                                          make((tw,), "bias"))
    return sd


def test_stretched_openai_checkpoint_builds_a_tower_the_step_trains(tmp_path):
    rng = np.random.default_rng(11)

    def make(shape, kind):
        fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        draw = {"conv": lambda: rng.standard_normal(shape) * np.sqrt(2.0 / fan_in),
                "linear": lambda: rng.standard_normal(shape) / np.sqrt(fan_in),
                "bn_weight": lambda: rng.uniform(0.7, 1.3, shape),
                "bias": lambda: rng.normal(0, 0.05, shape),
                "mean": lambda: rng.normal(0, 0.1, shape),
                "var": lambda: rng.uniform(0.5, 1.5, shape),
                "pos": lambda: rng.normal(0, 0.05, shape),
                "logit_scale": lambda: np.asarray(np.log(1 / 0.07))}[kind]()
        return torch.from_numpy(np.asarray(draw, np.float32))

    sd = openai_rn_state_dict(make, LAYERS, WIDTH, 64, 64, 64, 24, 512, 2)
    path = tmp_path / "rn.pt"
    torch.save(sd, path)
    cfg_kw, state = convert.load_clip_checkpoint(str(path), stretch_to_long=True)
    cfg = preset_of(CLIPConfig(**cfg_kw))
    assert cfg == dataclasses.replace(TINY_CFG, context_length=4 * 24 - 60)
    model = CLIP(cfg)
    model.load_state_dict(state)
    loaded = {k: v.clone() for k, v in model.state_dict().items()}
    img, tl, ts = triples(12, ctx=36)
    losses, _, _ = port_steps(model, [(img, tl, ts)] * 2, lr=1e-3, warmup_steps=1,
                              total_steps=10)
    assert all(np.isfinite(losses))
    now = model.state_dict()
    for s, blocks in enumerate(LAYERS, start=1):
        for b in range(blocks):
            src, dst = f"visual.layer{s}.{b}", f"visual.layer{s}_{b}"
            assert torch.equal(now[f"{dst}.bn2.mean"], sd[f"{src}.bn2.running_mean"])
            assert torch.equal(now[f"{dst}.bn2.var"], sd[f"{src}.bn2.running_var"])
            assert not torch.equal(now[f"{dst}.conv2.kernel"], loaded[f"{dst}.conv2.kernel"])
    assert not torch.equal(now["visual.stem_bn1.scale"], loaded["visual.stem_bn1.scale"])


def test_openai_rn50x64_shapes_take_the_preset():
    meta = openai_rn_state_dict(lambda shape, kind: torch.empty(shape, device="meta"),
                                (3, 15, 36, 10), 128, 1024, 448, 1024, 77, 49408, 12)
    kw = convert.infer_clip_config(meta)
    assert CLIPConfig(**kw) == dataclasses.replace(RN50X64, context_length=77, long_clip=False,
                                                   recompute=False)
    # what --stretch makes of it: Long-CLIP's 248 positions, and the preset's recomputation
    stretched = dataclasses.replace(CLIPConfig(**kw), context_length=248, long_clip=True)
    assert preset_of(stretched) is RN50X64
    assert preset_of(TINY_CFG) is TINY_CFG


@pytest.mark.parametrize("cfg", [VIT_B16, LONGCLIP_L14], ids=["vit_b16", "longclip_l14"])
def test_vit_optimizer_keeps_its_leaves(cfg):
    with torch.device("meta"):
        model = CLIP(cfg)
    state = create_longclip_state(model)
    held = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    names = {n for n, p in model.named_parameters() if id(p) in held}
    assert names == {n for n, _ in model.named_parameters()} - {"positional_embedding"}
    assert frozen_names(model) == {"positional_embedding"}
    assert cfg.recompute is False


class _Built(Exception):
    pass


def test_cli_builds_rn50x64(monkeypatch, tmp_path):
    seen = []

    def fake_clip(cfg):
        seen.append(cfg)
        raise _Built

    monkeypatch.setattr(clip_model, "CLIP", fake_clip)
    argv = ["--synthetic", "--device", "cpu", "--steps", "1", "--save-dir", str(tmp_path / "s")]
    with pytest.raises(_Built):
        train_longclip.main(argv + ["--clip-config", "rn50x64",
                                    "--clip-weights", str(tmp_path / "absent.pt")])
    ckpt = tmp_path / "RN50x64.pt"
    ckpt.write_bytes(b"")
    stretched = dataclasses.asdict(dataclasses.replace(RN50X64, recompute=False))
    monkeypatch.setattr(convert, "load_clip_checkpoint",
                        lambda path, stretch_to_long: (stretched, {}))
    with pytest.raises(_Built):
        train_longclip.main(argv + ["--clip-weights", str(ckpt), "--stretch"])
    assert seen == [RN50X64, RN50X64]
