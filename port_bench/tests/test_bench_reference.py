"""The plain references against the port at small sizes on the CPU, on the
weights the benchmark draws: the unfolded UNets, the port's folded serving graph
loaded from a trainer's checkpoint, CLIPSeg with CSA, and the whole fusion
pipeline."""

import numpy as np
import pytest
import torch

from port_bench.drivers.common import remove, write_checkpoint
from port_bench.reference import clipseg as ref_clipseg
from port_bench.reference import pipeline as P
from port_bench.reference import unet as ref_unet
from port_bench.traffic import generator
from port_bench.weights import make_weights, shapes_of

TINY_CLIP = dict(width=64, layers=2, patch=16, resolution=64, embed_dim=32, text_width=64,
                 text_layers=2, context=32, vocab=512, extract_layers=(0, 1), reduce_dim=16)


@pytest.mark.parametrize("name", ["egm_unet", "grfb_unet"])
def test_unet_reference_matches_the_port(name):
    from egm_unet_torch.models.registry import create_model

    ref = ref_unet.build(name, 8, 2)
    port = create_model(name, fold_bn=False, base_c=8)
    assert shapes_of(ref) == shapes_of(port)
    sd = make_weights(shapes_of(ref), 11, "cpu")
    ref.load_state_dict(sd)
    port.load_state_dict(sd)
    x = torch.randn(2, 64, 96, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a, b = ref.eval()(x), port.eval()(x)["out"]
    assert (a - b).abs().max() <= 1e-4 * a.abs().max()


def test_folded_checkpoint_matches_the_unfolded_reference():
    from egm_unet_torch.serving import Predictor, PredictorConfig

    ref = ref_unet.build("egm_unet", 8, 2)
    sd = make_weights(shapes_of(ref), 2 ** 33 + 1, "cpu")
    ref.load_state_dict(sd)
    d = write_checkpoint(sd)
    try:
        pred = Predictor.from_checkpoint(d, PredictorConfig(base_c=8, dtype="float32",
                                                            batch_size=2), device="cpu")
    finally:
        remove(d)
    x = torch.randn(2, 64, 128, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a, b = ref(x), pred.model(x)["out"]
    assert (a - b).abs().max() <= 1e-4 * a.abs().max()


def test_clipseg_reference_matches_the_port():
    from egm_unet_torch.cli.eval_clipseg import tiny_clip_config
    from egm_unet_torch.models.clipseg import CLIPDensePredT

    port = CLIPDensePredT(clip_cfg=tiny_clip_config(64), reduce_dim=16,
                          extract_layers=(0, 1)).eval()
    ref = ref_clipseg.build(**TINY_CLIP)
    assert shapes_of(ref) == shapes_of(port)
    sd = make_weights(shapes_of(ref), 5, "cpu")
    ref.load_state_dict(sd)
    port.load_state_dict(sd)
    x = torch.randn(3, 96, 96, 3, generator=torch.Generator().manual_seed(2))
    c = torch.randn(3, 32, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        a, b = ref(x, c), port(x, c)[0][..., 0]
    assert (a - b).abs().max() <= 1e-4 * a.abs().max()


def test_reference_preprocessing_matches_the_port():
    from egm_unet_torch.cli.eval_clipseg import preprocess

    raws = generator.frames({"frames": [[50, 70, 0.5], [70, 50, 0.5]], "pool": 2}, 3)
    small, clip = preprocess(raws, 40, 32)
    for raw, s, c in zip(raws, small, clip):
        hw = P.short_side(raw.shape[:2], 40)
        np.testing.assert_array_equal(P.normalize(P.pil_resize(raw, hw), P.TP_MEAN, P.TP_STD), s)
        np.testing.assert_array_equal(
            P.normalize(P.pil_resize(raw, (32, 32)), P.IMAGENET_MEAN, P.IMAGENET_STD), c)
