"""The Long-CLIP contrastive loss across 2 gloo ranks on the CPU
(``engine/longclip_train.py`` with a group: per-rank PCA, the differentiable
all-gather, targets offset by ``rank * b``, the mean over the ranks) against
the JAX package's ``make_longclip_loss_fn(clip, mesh=...)`` under a 2-device
mesh, on a tiny Long-CLIP from the weights JAX's trainer starts from
(jitted ``model.init``, as ``tests/test_torch_longclip_train.py``), with
48-wide features, batch 80.

Bounds: the loss within 1e-5 relative; every gradient leaf within 1e-4 of
that leaf's largest (the one-process step's bar in
``test_torch_longclip_train.py``).  One spawn of 2 ranks (about 8 s)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from egm_unet_tpu.engine import longclip_train as jlc
from egm_unet_tpu.models.clip import model as jmodel
from egm_unet_tpu.parallel import get_mesh
from egm_unet_torch.engine import longclip_train as lc
from egm_unet_torch.models.clip.model import CLIP, CLIPConfig
from egm_unet_torch.parallel import launch
from egm_unet_torch.utils import flax_from_state_dict, load_flax_variables

from tests.torch_dist_util import longclip_grads
from tests.torch_train_util import flat, one_thread

KW = dict(embed_dim=48, image_resolution=32, vision_layers=2, vision_width=64,
          vision_patch_size=16, context_length=16, vocab_size=128,
          transformer_width=32, transformer_heads=2, transformer_layers=1,
          long_clip=True)
# 40 rows a rank: the PCA-32 proxy drops directions (at 33 rows or fewer it
# keeps every one, and is the features themselves)
BATCH = 80


@pytest.fixture(autouse=True)
def _grad_on():
    with one_thread():
        yield


def batch():
    rng = np.random.default_rng(11)
    img = rng.standard_normal((BATCH, 32, 32, 3)).astype(np.float32)
    tl, ts = (rng.integers(1, KW["vocab_size"] - 1, (BATCH, KW["context_length"]))
              .astype(np.int32) for _ in range(2))
    return img, tl, ts


@functools.lru_cache(maxsize=None)
def jax_side():
    """(params, loss, flat gradients) of the JAX loss under a 2-device mesh."""
    jm = jmodel.CLIP(jmodel.CLIPConfig(**KW))
    img, tl, ts = batch()
    params = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(img[:1]),
                              jnp.asarray(tl[:1]))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    mesh = get_mesh(n_data=2, devices=jax.devices()[:2])
    with jax.set_mesh(mesh):
        sh = NamedSharding(mesh, P("data"))
        args = [jax.device_put(jnp.asarray(a), sh) for a in (img, tl, ts)]
        loss_fn = jlc.make_longclip_loss_fn(jm, mesh=mesh)
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, *args)
    return params, float(loss), flat(grads)


@functools.lru_cache(maxsize=None)
def port_model():
    return load_flax_variables(CLIP(CLIPConfig(**KW)), {"params": jax_side()[0]})


@functools.lru_cache(maxsize=None)
def ranks():
    return launch(longclip_grads, 2, "gloo", KW, port_model().state_dict(), batch())


def port_grads(rank):
    grads = {k: torch.from_numpy(v) for k, v in ranks()[rank]["grads"].items()}
    return flat(flax_from_state_dict(port_model(), grads)["params"])


def test_loss_across_ranks_matches_jax_mesh():
    _, loss, _ = jax_side()
    for r in ranks():
        assert r["loss"] == pytest.approx(loss, rel=1e-5)


@pytest.mark.parametrize("rank", [0, 1])
def test_every_gradient_leaf_matches_jax_mesh(rank):
    _, _, ref = jax_side()
    got = port_grads(rank)
    assert set(got) == set(ref)
    for path, g in got.items():
        r = ref[path]
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * np.abs(r).max() + 1e-12,
                                   err_msg=path)


def test_per_rank_pca_is_not_the_whole_batch_pca():
    """Each rank's PCA proxy comes from its own 40 rows: the loss across the
    ranks is another number than one process's loss on the whole batch."""
    img, tl, ts = (torch.from_numpy(a) for a in batch())
    with torch.no_grad():
        whole = lc.make_longclip_loss_fn()(port_model(), img, tl.long(), ts.long())
    assert abs(whole.item() - ranks()[0]["loss"]) > 1e-4
