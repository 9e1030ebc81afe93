"""Tensor parallelism of the CLIP towers (``parallel/tp.py``) on a 1 x 2 grid
of gloo ranks on the CPU, against the JAX package
(``tests/test_tensor_parallel.py``'s TINY config, ``dryrun_multichip``'s
Long-CLIP loss under ``get_mesh(1, 2)``), from seeded weights
(``init_weights``) converted to a flax tree (``flax_from_state_dict``).

- ``clip_param_specs`` equals JAX's ``clip_param_specs`` leaf for leaf
  through ``from_flax``'s names, on TINY and on an RN tower (whose
  attention pool's ``c_proj`` is row-split);
- ``encode_text`` / ``encode_image`` of the sharded towers against JAX's
  single device, within 2e-4 (TINY's one 64-wide vision head stays whole on
  both ranks, its MLP split; the text tower's 2 heads split);
- the Long-CLIP loss and the gradients ``gather_clip_state`` reassembles
  against JAX's ``make_longclip_loss_fn`` under ``get_mesh(1, 2)`` with
  ``shard_clip_params``, within 1e-4 (the loss relative; each gradient leaf
  of that leaf's largest, the bar of ``tests/test_torch_dp_longclip.py``);
  a Long-CLIP of 4 vision heads of 64, so that K6's CSA block runs 2 local
  heads a rank.

One spawn of 2 ranks (about 8 s), in a thread of the test process while
the JAX programs compile there."""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from egm_unet_tpu.engine import longclip_train as jlc
from egm_unet_tpu.models.clip import model as jmodel
from egm_unet_tpu.parallel import get_mesh
from egm_unet_tpu.parallel.tp import clip_param_specs as j_specs
from egm_unet_tpu.parallel.tp import shard_clip_params
from egm_unet_torch.models.clip.model import CLIP, CLIPConfig
from egm_unet_torch.models.registry import init_weights
from egm_unet_torch.parallel import clip_param_specs, launch
from egm_unet_torch.utils import flax_from_state_dict
from egm_unet_torch.utils.from_flax import flax_path

from tests.torch_dist_util import tp_cases
from tests.torch_train_util import flat, one_thread

TINY = dict(embed_dim=32, image_resolution=32, vision_layers=2, vision_width=64,
            vision_patch_size=16, context_length=16, vocab_size=128,
            transformer_width=64, transformer_heads=2, transformer_layers=2,
            long_clip=False)
# Long-CLIP with 4 vision heads (CLIPConfig.vision_heads is width // 64)
LONG = dict(TINY, long_clip=True, vision_width=256, vision_layers=1)
RN = dict(TINY, vision_layers=(1, 1, 1, 1), vision_width=16, image_resolution=64)
SPEC_NAMES = {P(None, "model"): "column", P("model"): "column",
              P("model", None): "row", P(): "replicated"}


@pytest.fixture(autouse=True)
def _grad_on():
    with one_thread():
        yield


@functools.lru_cache(maxsize=None)
def port_model(name):
    kw = {"tiny": TINY, "long": LONG}[name]
    return init_weights(CLIP(CLIPConfig(**kw)), torch.Generator().manual_seed(0))


def j_params(name):
    return flax_from_state_dict(port_model(name))["params"]


def batch(kw, n=8, seed=11):
    rng = np.random.default_rng(seed)
    res = kw["image_resolution"]
    img = rng.standard_normal((n, res, res, 3)).astype(np.float32)
    tl, ts = (rng.integers(1, kw["vocab_size"] - 1, (n, kw["context_length"]))
              .astype(np.int32) for _ in range(2))
    return img, tl, ts


@functools.lru_cache(maxsize=None)
def jax_side():
    """TINY's single-device features and the Long-CLIP loss and flat
    gradients under a 1 x 2 (data x model) mesh."""
    tp_future()  # the ranks run while JAX compiles
    jm = jmodel.CLIP(jmodel.CLIPConfig(**TINY))
    img, tl, _ = batch(TINY)
    params = j_params("tiny")
    enc = (np.asarray(jax.jit(functools.partial(jm.apply, method=jm.encode_image))(
               {"params": params}, img)),
           np.asarray(jax.jit(functools.partial(jm.apply, method=jm.encode_text))(
               {"params": params}, tl)))
    jl = jmodel.CLIP(jmodel.CLIPConfig(**LONG))
    mesh = get_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    with jax.set_mesh(mesh):
        loss, grads = jax.jit(jax.value_and_grad(jlc.make_longclip_loss_fn(jl, mesh=mesh)))(
            shard_clip_params(j_params("long"), mesh),
            *(jnp.asarray(a) for a in batch(LONG)))
    return enc, float(loss), flat(grads)


def tp_launch():
    img, tl, _ = batch(TINY)
    return launch(tp_cases, 2, "gloo",
                  (TINY, port_model("tiny").state_dict(), img, tl),
                  (LONG, port_model("long").state_dict(), batch(LONG)), grid=(1, 2))


@functools.lru_cache(maxsize=None)
def tp_future():
    return ThreadPoolExecutor(1).submit(tp_launch)


def ranks():
    return tp_future().result()


@pytest.mark.parametrize("kw", [TINY, RN], ids=["tiny", "rn"])
def test_specs_equal_jax_leaf_for_leaf(kw):
    jm = jmodel.CLIP(jmodel.CLIPConfig(**kw))
    res = kw["image_resolution"]
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, res, res, 3)),
                            jnp.zeros((1, kw["context_length"]), jnp.int32))["params"]
    ref = {"/".join(str(k.key) for k in path): SPEC_NAMES[s] for path, s in
           jax.tree_util.tree_leaves_with_path(j_specs(shapes),
                                               is_leaf=lambda s: isinstance(s, P))}
    model = CLIP(CLIPConfig(**kw))
    got = {flax_path(model, k): v for k, v in clip_param_specs(model).items()}
    assert got == ref
    if kw is RN:
        assert got["visual/attnpool/c_proj/kernel"] == "row"


def test_sharded_towers_match_jax_single_device():
    (ref_i, ref_t), _, _ = jax_side()
    for r in ranks():
        np.testing.assert_allclose(r["image"], ref_i, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(r["text"], ref_t, rtol=2e-4, atol=2e-4)
        # TINY: two vision blocks of one head, whole; two text blocks of 2,
        # split; the Long-CLIP's vision block runs 2 of its 4 heads
        assert r["heads"] == [1, 1, 1, 1]
        assert r["long_heads"] == [2, 1, 1]


def test_longclip_loss_matches_jax_model_mesh():
    _, loss, _ = jax_side()
    for r in ranks():
        assert r["loss"] == pytest.approx(loss, rel=1e-4)


@pytest.mark.parametrize("rank", [0, 1])
def test_gathered_gradients_match_jax_model_mesh(rank):
    _, _, ref = jax_side()
    model = CLIP(CLIPConfig(**LONG))
    got = {flax_path(model, k): v for k, v in ranks()[rank]["grads"].items()}
    assert set(got) == set(ref)
    for path, g in got.items():
        r = ref[path]
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * np.abs(r).max() + 1e-12,
                                   err_msg=path)


def test_gather_clip_state_is_the_full_state_dict():
    """The shards gathered back are the weights the ranks were given, bit
    for bit, under the unsharded names and shapes."""
    full = port_model("long").state_dict()
    for r in ranks():
        assert set(r["state"]) == set(full)
        for k, v in full.items():
            np.testing.assert_array_equal(r["state"][k], v.numpy(), err_msg=k)
