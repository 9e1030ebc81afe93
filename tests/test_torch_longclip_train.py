"""egm_unet_torch Long-CLIP fine-tune (``engine/longclip_train.py``) against
egm_unet_tpu on the CPU in float32: the PCA proxy (values and gradients
against ``jax.vjp``, the identity below 2 rows), the smoothed cross-entropy,
the contrastive loss, the warm-up cosine schedule, and the train step of a
tiny Long-CLIP from the weights JAX's trainer starts from (``model.init``),
with the logit-scale clamp hit on purpose.

Tolerances: PCA values 1e-5 and gradients 1e-4 relative on features with a
spectral gap at the kept dimension (SVD subspaces of a degenerate spectrum
are not unique); the losses 1e-5 relative; the schedule 1e-6 relative at
every step.  The train step: the first step's gradients within 1e-4 of each
leaf's largest; after 1 and 3 steps the loss 1e-5 relative at every step,
``lr`` 1e-6, ``positional_embedding`` bit-identical in both packages,
``logit_scale`` clamped to ln 100 in both, and every other element within
``1e-2 * lr * steps`` of JAX's on 99% of them and ``2 * lr * steps`` on all
(AdamW normalizes each gradient element by its own size, so elements whose
gradient is within float32 noise of zero move by noise in both packages;
``tests/test_torch_clipseg_train.py`` says more)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egm_unet_tpu.engine import longclip_train as jlc
from egm_unet_tpu.models.clip import model as jmodel

from egm_unet_torch.engine import longclip_train as lc
from egm_unet_torch.models.clip.model import CLIP, CLIPConfig
from egm_unet_torch.ops.cuda import launch_counts, reset_launch_counts
from egm_unet_torch.utils import flax_from_state_dict, load_flax_variables

from tests.torch_port_util import to_torch
from tests.torch_train_util import flat, one_thread

KW = dict(embed_dim=16, image_resolution=32, vision_layers=2, vision_width=64,
          vision_patch_size=16, context_length=16, vocab_size=128,
          transformer_width=32, transformer_heads=2, transformer_layers=1,
          long_clip=True)
LR, WARMUP, TOTAL, BATCH = 1e-3, 1, 4, 4


@pytest.fixture(autouse=True)
def _grad_on():
    with one_thread():
        yield


def _gapped(rng, b=8, d=16, rank=4):
    """Rows dominated by a rank-``rank`` part: a clear spectral gap."""
    basis = rng.standard_normal((rank, d)).astype(np.float32) * 3.0
    return (rng.standard_normal((b, rank)).astype(np.float32) @ basis
            + 0.01 * rng.standard_normal((b, d)).astype(np.float32))


def test_pca_values_and_gradients_match_jax_vjp():
    rng = np.random.default_rng(0)
    x = _gapped(rng)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    ref, vjp = jax.vjp(lambda a: jlc.pca_reconstruct(a, 4), jnp.asarray(x))
    (ref_g,) = vjp(jnp.asarray(ct))
    tx = to_torch(x).requires_grad_(True)
    out = lc.pca_reconstruct(tx, 4)
    (g,) = torch.autograd.grad(out, tx, to_torch(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), rtol=1e-4,
                               atol=1e-4 * np.abs(ref_g).max())


def test_pca_one_row_is_the_identity():
    x = np.random.default_rng(1).standard_normal((1, 8)).astype(np.float32)
    ct = np.arange(8, dtype=np.float32)[None]
    ref, vjp = jax.vjp(lambda a: jlc.pca_reconstruct(a, 4), jnp.asarray(x))
    tx = to_torch(x).requires_grad_(True)
    out = lc.pca_reconstruct(tx, 4)
    (g,) = torch.autograd.grad(out, tx, to_torch(ct))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    np.testing.assert_array_equal(g.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]))
    np.testing.assert_array_equal(g.numpy(), ct)


def test_cross_entropy_smoothed_matches_jax_and_torch():
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((6, 10)) * 3).astype(np.float32)
    targets = rng.integers(0, 10, 6)
    ref = float(jlc.cross_entropy_smoothed(jnp.asarray(logits), jnp.asarray(targets)))
    got = float(lc.cross_entropy_smoothed(to_torch(logits), torch.from_numpy(targets)))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    np.testing.assert_allclose(got, float(torch.nn.functional.cross_entropy(
        to_torch(logits), torch.from_numpy(targets), label_smoothing=0.1)), rtol=1e-5)


@pytest.mark.parametrize("pca_dim", [4, 32])
def test_contrastive_loss_matches_jax(pca_dim):
    rng = np.random.default_rng(3)
    img = _gapped(rng, b=8, d=16)
    tl, ts = (rng.standard_normal((8, 16)).astype(np.float32) for _ in range(2))
    scale = np.float32(np.log(1 / 0.07))
    ref = jlc.longclip_contrastive_loss(*(jnp.asarray(a) for a in (img, tl, ts, scale)),
                                        pca_dim=pca_dim)
    got = lc.longclip_contrastive_loss(*(to_torch(a) for a in (img, tl, ts, scale)),
                                       pca_dim=pca_dim)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(float(g), float(r), rtol=1e-5)


@pytest.mark.parametrize("warmup,total", [(3, 10), (0, 6), (200, 5), (2, 2), (1, 1)])
def test_schedule_every_step_with_the_warmup_clamp(warmup, total):
    state = jlc.create_longclip_state(
        types.SimpleNamespace(apply=None),
        {"w": jnp.zeros(2), "positional_embedding": jnp.zeros(2)}, lr=LR,
        warmup_steps=warmup, total_steps=total)
    port = lc.longclip_schedule(LR, warmup, total)
    for s in range(total + 4):
        np.testing.assert_allclose(port(s), float(state.lr_fn(s)), rtol=1e-6,
                                   atol=1e-12, err_msg=f"step {s}")
    assert port(total + 3) == pytest.approx(LR * 1e-2, rel=1e-5)


@pytest.fixture(scope="module")
def pair():
    """The JAX model and the weights its trainer starts from (jitted
    ``model.init``), ``logit_scale`` set above ln 100 so that the clamp
    acts."""
    jm = jmodel.CLIP(jmodel.CLIPConfig(**KW))
    img, tl, _ = _batches(1)[0]
    params = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(img), jnp.asarray(tl))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    params["logit_scale"] = np.asarray(jlc.MAX_LOGIT_SCALE + 0.5, np.float32)
    return jm, params


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        img = rng.standard_normal((BATCH, 32, 32, 3)).astype(np.float32)
        tl, ts = (rng.integers(1, KW["vocab_size"] - 1, (BATCH, KW["context_length"]))
                  .astype(np.int32) for _ in range(2))
        out.append((img, tl, ts))
    return out


def _port_state(params):
    model = load_flax_variables(CLIP(CLIPConfig(**KW)), {"params": params})
    return lc.create_longclip_state(model, lr=LR, warmup_steps=WARMUP, total_steps=TOTAL)


def test_state_freezes_positional_embedding(pair):
    state = _port_state(pair[1])
    in_opt = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    for name, p in state.model.named_parameters():
        frozen = name == "positional_embedding"
        assert p.requires_grad != frozen and (id(p) in in_opt) != frozen, name
    assert state.optimizer.param_groups[0]["weight_decay"] == 1e-2


def test_first_step_gradients_match_jax(pair):
    jm, params = pair
    img, tl, ts = _batches(1, seed=4)[0]
    loss_fn = jlc.make_longclip_loss_fn(jm)
    ref = flat(jax.jit(jax.grad(loss_fn))(params, *(jnp.asarray(a) for a in (img, tl, ts))))
    state = _port_state(params)
    lc.make_longclip_train_step()(state, to_torch(img), torch.from_numpy(tl),
                                  torch.from_numpy(ts))
    grads = {k: p.grad for k, p in state.model.named_parameters() if p.requires_grad}
    got = flat(flax_from_state_dict(state.model, grads)["params"])
    assert set(got) == set(ref) - {"positional_embedding"}
    for path, g in got.items():
        r = ref[path]
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * np.abs(r).max() + 1e-12,
                                   err_msg=path)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_jax(pair, n_steps):
    jm, params = pair
    jstate = jlc.create_longclip_state(jm, params, lr=LR, warmup_steps=WARMUP,
                                       total_steps=TOTAL)
    jstep = jax.jit(jlc.make_longclip_train_step(jm))
    state = _port_state(params)
    step = lc.make_longclip_train_step()
    pe = state.model.positional_embedding.detach().clone()
    reset_launch_counts()
    clamp = float(np.float32(jlc.MAX_LOGIT_SCALE))
    for i, (img, tl, ts) in enumerate(_batches(n_steps, seed=5)):
        jstate, jaux = jstep(jstate, *(jnp.asarray(a) for a in (img, tl, ts)))
        state, aux = step(state, to_torch(img), torch.from_numpy(tl), torch.from_numpy(ts))
        np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-5)
        np.testing.assert_allclose(aux["lr"], float(jaux["lr"]), rtol=1e-6)
        scales = float(jstate.params["logit_scale"]), float(state.model.logit_scale)
        assert max(scales) <= clamp
        if i == 0:  # the warm-up's first rate is 0: the clamp alone moves it
            assert scales == (clamp, clamp)
    assert launch_counts()["csa_attention"] == 0  # CPU tensors: the plain version
    assert torch.equal(state.model.positional_embedding, pe)
    want = flat(jstate.params)
    np.testing.assert_array_equal(want["positional_embedding"], params["positional_embedding"])
    got = flat(flax_from_state_dict(state.model)["params"])
    assert set(got) == set(want)
    diff = np.concatenate([np.abs(got[p] - want[p]).ravel() for p in want])
    assert diff.max() <= 2 * LR * n_steps
    assert np.quantile(diff, 0.99) <= 1e-2 * LR * n_steps
    before = flat(params)
    moved = sum(not np.array_equal(want[p], before[p]) for p in want)
    assert moved == (1 if n_steps == 1 else len(want) - 1)  # all but the frozen table
