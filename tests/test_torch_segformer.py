"""SegFormer (``models/segformer.py``) on the CPU.  The JAX package has no
SegFormer, so the port is held against the benchmark's plain float32
reference (``port_bench/reference/segformer.py``) on seeded weights drawn
for the BatchNorm graph's names (``port_bench/weights.py``), at tiny widths:
hidden [8, 16, 40, 64], depths [1, 1, 2, 1], heads [1, 2, 5, 8] (head
width 8), decoder 32, on 64x64 inputs.

- The preset: SegFormer-B5 at its published widths, counted on the meta
  device.
- The folded program (the head's BatchNorm folded by
  ``utils/checkpoint.py::folded_state_dict``) against the reference, and the
  BatchNorm graph against the folded graph.
- ``ops/attention.py::sdpa_attention`` against ``multi_head_attention``
  where the keys are the queries' count, and against a plain float32
  softmax where they are fewer.
- ``Predictor.from_checkpoint(model_name="segformer_b5")`` and
  ``cli/predict.py --model segformer_b5`` on a trainer's checkpoint (the
  tiny widths stand in for the preset), its cast, its spans and counters.
"""

import dataclasses
import math
import os

import numpy as np
import pytest
import torch

from egm_unet_torch.models import create_model, segformer
from egm_unet_torch.models.segformer import SEGFORMER_B5, SegFormer, SegFormerConfig
from egm_unet_torch.nn.layers import LayerNorm
from egm_unet_torch.ops.attention import multi_head_attention, sdpa_attention
from egm_unet_torch.serving import Predictor, PredictorConfig
from egm_unet_torch.utils import profiling
from egm_unet_torch.utils.checkpoint import folded_state_dict
from port_bench.reference import segformer as ref_seg
from port_bench.weights import make_weights, shapes_of

TINY = SegFormerConfig(hidden_sizes=(8, 16, 40, 64), depths=(1, 1, 2, 1),
                       num_attention_heads=(1, 2, 5, 8), decoder_hidden_size=32)
ARCH = {k: (list(v) if isinstance(v, tuple) else v)
        for k, v in dataclasses.asdict(TINY).items() if k != "num_labels"}


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def _weights(seed=3):
    """The BatchNorm graph's state dict in the reference's names."""
    meta = ref_seg.build(ARCH, 2, device="meta")
    return make_weights(shapes_of(meta), seed, "cpu")


def _frames(n=2, seed=4):
    return torch.randn(n, 64, 64, 3, generator=torch.Generator().manual_seed(seed))


def _checkpoint(tmp_path, state):
    d = tmp_path / "ckpt"
    (d / "0").mkdir(parents=True)
    torch.save({"state": {"model": state}, "epoch": 0, "best_dice": 0.0},
               d / "0" / "checkpoint.pt")
    return str(d)


@pytest.fixture
def tiny_preset(monkeypatch):
    monkeypatch.setitem(segformer.PRESETS, "segformer_b5", TINY)


def test_preset_is_segformer_b5_at_its_published_widths():
    assert SEGFORMER_B5 == SegFormerConfig(
        hidden_sizes=(64, 128, 320, 512), depths=(3, 6, 40, 3), num_attention_heads=(1, 2, 5, 8),
        sr_ratios=(8, 4, 2, 1), patch_sizes=(7, 3, 3, 3), strides=(4, 2, 2, 2), mlp_ratio=4,
        decoder_hidden_size=768, layer_norm_eps=1e-6, num_labels=2)
    with torch.device("meta"):
        bn = create_model("segformer_b5", num_classes=2, fold_bn=False)
        folded = create_model("segformer_b5", num_classes=2)
        ade = create_model("segformer_b5", num_classes=150, fold_bn=False)
    count = lambda m: sum(p.numel() for p in m.parameters())  # noqa: E731
    # the BatchNorm statistics are buffers: not counted
    assert count(bn) == 84_594_882 and count(folded) == 84_594_882 - 768
    assert round(count(ade) / 1e6, 1) == 84.7  # the paper's B5, ADE20K's 150 classes
    shapes = shapes_of(bn)
    assert shapes["patch_embed1.proj.kernel"] == (7, 7, 3, 64)
    assert shapes["block1.2.attn.sr.kernel"] == (8, 8, 64, 64)
    assert shapes["block3.39.mlp.dwconv.kernel"] == (3, 3, 1, 1280)
    assert shapes["block4.2.attn.kv.kernel"] == (512, 1024)
    assert "block4.0.attn.sr.kernel" not in shapes  # ratio 1: no reduction
    assert shapes["head.linear_fuse.Conv_0.kernel"] == (1, 1, 3072, 768)
    assert shapes["head.linear_c.3.kernel"] == (512, 768)
    assert sum(SEGFORMER_B5.depths) == 52
    norms = [m for m in bn.modules() if isinstance(m, LayerNorm)]
    # mmseg's patch embeds (4) and reductions (49, ratio > 1) take nn.LayerNorm's
    # default eps; the blocks and the stages' ends take layer_norm_eps
    plain = [n for n, m in bn.named_modules() if isinstance(m, LayerNorm) and m.eps == 1e-5]
    assert len(norms) == 161 and {m.eps for m in norms} == {1e-5, 1e-6}
    assert len(plain) == 53 and all(n.endswith(("patch_embed1.norm", "patch_embed2.norm",
                                                "patch_embed3.norm", "patch_embed4.norm",
                                                "attn.norm")) for n in plain)
    assert shapes_of(bn) == shapes_of(ref_seg.build(
        {k: (list(v) if isinstance(v, tuple) else v)
         for k, v in dataclasses.asdict(SEGFORMER_B5).items()}, 2, device="meta"))


def test_folded_program_matches_the_reference(tmp_path, tiny_preset):
    w = _weights()
    folded = create_model("segformer_b5", num_classes=2)
    folded.load_state_dict(folded_state_dict(_checkpoint(tmp_path, w), "segformer_b5", 2, 32))
    x = _frames()
    with torch.no_grad():
        got = folded.eval()(x)["out"]
        want = ref_seg.build(ARCH, 2, w)(x)
    assert got.shape == (2, 64, 64, 2)
    assert _rel(got, want) < 1e-5


def test_batchnorm_graph_folds_to_the_folded_graph(tmp_path, tiny_preset):
    w = _weights(seed=8)
    bn = create_model("segformer_b5", num_classes=2, fold_bn=False).eval()
    bn.load_state_dict(w)
    folded = create_model("segformer_b5", num_classes=2).eval()
    folded.load_state_dict(folded_state_dict(_checkpoint(tmp_path, w), "segformer_b5", 2, 32))
    assert not any("BatchNorm_0" in k for k in folded.state_dict())
    x = _frames(seed=9)
    with torch.no_grad():
        assert _rel(folded(x)["out"], bn(x)["out"]) < 1e-5


@pytest.mark.parametrize("heads", [1, 5])
def test_sdpa_attention_equals_multi_head_attention_at_m_equal_n(heads):
    gen = torch.Generator().manual_seed(heads)
    q, k, v = (torch.randn(2, 48, 40, generator=gen) for _ in range(3))
    assert _rel(sdpa_attention(q, k, v, heads), multi_head_attention(q, k, v, heads)) < 1e-6


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.bfloat16, 1e-2)])
def test_sdpa_attention_over_fewer_keys_is_a_plain_softmax(dtype, tol):
    gen = torch.Generator().manual_seed(7)
    q = torch.randn(3, 96, 16, generator=gen)
    k, v = (torch.randn(3, 12, 16, generator=gen) for _ in range(2))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    got = sdpa_attention(q, k, v, 2)
    assert got.shape == (3, 96, 16) and got.dtype == dtype
    qf, kf, vf = (t.float().reshape(3, -1, 2, 8).transpose(1, 2) for t in (q, k, v))
    p = torch.softmax(qf @ kf.transpose(-1, -2) / math.sqrt(8), dim=-1)
    want = (p @ vf).transpose(1, 2).reshape(3, 96, 16)
    assert _rel(got.float(), want) < tol


def test_predictor_from_checkpoint_serves_masks_of_the_input_size(tmp_path, tiny_preset):
    ckpt = _checkpoint(tmp_path, _weights())
    cfg = PredictorConfig(model_name="segformer_b5", batch_size=2, base_size=64)
    pred = Predictor.from_checkpoint(ckpt, cfg, device="cpu")
    # the deployment cast: convs and Linears in bf16, the norms in float32
    assert pred.model.block1[0].attn.q.kernel.dtype == torch.bfloat16
    assert pred.model.head.linear_fuse.Conv_0.kernel.dtype == torch.bfloat16
    assert pred.model.norm4.scale.dtype == torch.float32
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in ((70, 90), (64, 64), (90, 70))]
    masks = pred.predict(images)
    assert [m.shape for m in masks] == [im.shape[:2] for im in images]
    assert all(m.dtype == np.uint8 and int(m.max()) <= 1 for m in masks)
    with pytest.raises(ValueError, match="no int8 route"):
        Predictor(config=dataclasses.replace(cfg, quant="int8df"), device="cpu")


def test_predict_cli_serves_segformer(tmp_path, tiny_preset, capsys):
    from egm_unet_torch.cli import predict

    ckpt = _checkpoint(tmp_path, _weights())
    out = tmp_path / "masks"
    predict.main(["--synthetic", "--device", "cpu", "--model", "segformer_b5",
                  "--base-size", "64", "--weights", ckpt, "--save-result", str(out)])
    assert f"loaded weights from {ckpt}" in capsys.readouterr().out
    assert len(os.listdir(out)) == 4


def test_spans_and_counters():
    model = SegFormer(TINY).eval()
    profiling.reset_table()
    with torch.no_grad():
        model(_frames(1))
        with profiling.recording():
            model(_frames(1))
            model(_frames(1))
    tab = profiling.table()
    assert tab["segformer.forwards"]["value"] == 2
    assert tab["segformer.attention_calls"]["value"] == 2 * sum(TINY.depths)
    for name in ("segformer.stage1", "segformer.stage2", "segformer.stage3",
                 "segformer.stage4", "segformer.head"):
        assert tab[name]["count"] == 2 and tab[name]["parent"] is None
    profiling.reset_table()
