"""egm_unet_torch's Predictor against the JAX package's Predictor: same
weights, float32, three synthetic images of different sizes and buckets.
Masks must have the original shapes and agree on >= 99.9% of pixels (an
argmax can flip where two logits tie to within float32 roundoff)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egm_unet_tpu.models import create_model as jcreate
from egm_unet_tpu.serving import Predictor as JPredictor
from egm_unet_tpu.serving import PredictorConfig as JConfig

from egm_unet_torch.data.synthetic import synthetic_tp_sample
from egm_unet_torch.serving import Predictor, PredictorConfig

from tests.torch_port_util import random_variables


def test_predictor_matches_jax():
    images = [synthetic_tp_sample(i, h, w)[0]
              for i, (h, w) in enumerate([(40, 52), (48, 48), (30, 90)])]
    v = random_variables(jcreate("egm_unet", base_c=8), jnp.zeros((1, 64, 64, 3)),
                         train=True, seed=3)
    kw = dict(base_c=8, batch_size=2, base_size=32, dtype="float32")
    ref = JPredictor(v, JConfig(**kw)).predict(images)
    out = Predictor(v, PredictorConfig(**kw), device="cpu").predict(images)
    agree = total = 0
    for img, m, r in zip(images, out, ref):
        assert m.shape == img.shape[:2] and m.dtype == np.uint8
        agree += int((m == r).sum())
        total += m.size
    assert agree / total >= 0.999, agree / total
    # random weights still give a mask that depends on the image
    assert 0 < sum(int(m.sum()) for m in out) < total


def test_predictor_random_weights_are_seeded():
    cfg = PredictorConfig(base_c=8, batch_size=1, base_size=32, dtype="float32")
    a = Predictor(config=cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    b = Predictor(config=cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    for (k, ta), tb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(ta, tb), k
    img = synthetic_tp_sample(0, 40, 40)[0]
    np.testing.assert_array_equal(a.predict([img])[0], b.predict([img])[0])


def test_predictor_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor()
