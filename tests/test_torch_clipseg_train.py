"""egm_unet_torch CLIPSeg training (``engine/clipseg_train.py``,
``engine/clipseg_metrics.py``) against egm_unet_tpu on the CPU in float32:
the loss, the schedule, the fgIoU probe, the fixed-interval metrics, and the
train step of a tiny CLIPSeg from the same bridged weights.

Tolerances: the loss and fgIoU 1e-6 relative (the same float32 formula);
the schedule 1e-6 relative at every step of a short run and past ``t_max``;
metric counts exact and the derived metrics 1e-6 (float32 in JAX, float64
here).  The train step in three parts:
- the first step's gradients: every decoder leaf within 1e-4 of the leaf's
  largest JAX gradient;
- AdamW on the same gradients (three steps, the tower masked out): every
  leaf within 1e-6 relative, 1e-7 absolute (a few float32 steps of leaves
  near 0.1: torch and optax order the update's operations differently);
- one and three whole steps from the weights JAX's trainer starts from
  (``model.init``): the loss 1e-5 relative at every step, ``lr`` 1e-6, the
  frozen tower bit-identical before and after in both packages, and the
  decoder's elements within ``1e-2 * lr * steps`` of JAX's on 99% of them
  and within ``2 * lr * steps`` (the most AdamW moves an element) on all.
  Adam divides each gradient element by its own size, so an element whose
  gradient is zero (the key bias of every attention: softmax ignores a
  constant added to a row) or small moves by an amount its float32 noise
  sets, in both packages alike; and the model's float32 gradients are
  ill-conditioned (a 1e-6 relative change of the input moves the port's own
  gradients by 2e-5 of a leaf's largest).  The whole-model float64 remedy of
  the UNet tests is not open here: both packages compute LayerNorm in
  float32.  Measured: 99% of elements within 3e-5 (one step) and 7e-4 (three
  steps) of ``lr * steps``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from egm_unet_tpu.engine import clipseg_metrics as jmetrics
from egm_unet_tpu.engine import clipseg_train as jtrain
from egm_unet_tpu.models import clipseg as jclipseg
from egm_unet_tpu.models.clip import model as jmodel

from egm_unet_torch.engine import clipseg_metrics as metrics
from egm_unet_torch.engine import clipseg_train as train
from egm_unet_torch.models.clip.model import CLIPConfig
from egm_unet_torch.models.clipseg import CLIPDensePredT
from egm_unet_torch.ops.cuda import launch_counts, reset_launch_counts
from egm_unet_torch.utils import flax_from_state_dict, load_flax_variables
from egm_unet_torch.utils.from_flax import flax_path as flat_path

from tests.torch_port_util import to_torch
from tests.torch_train_util import flat, one_thread

KW = dict(embed_dim=32, image_resolution=32, vision_layers=3, vision_width=64,
          vision_patch_size=16, context_length=16, vocab_size=128,
          transformer_width=32, transformer_heads=2, transformer_layers=1,
          long_clip=True)
MKW = dict(extract_layers=(1, 2), reduce_dim=16)  # no 0: see test_torch_clipseg.py
LR, T_MAX, ETA_MIN = 1e-3, 2, 1e-4  # three steps cross t_max


@pytest.fixture(autouse=True)
def _grad_on():
    with one_thread():
        yield


def _batches(n, seed=0, batch=2, size=32):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        img = rng.standard_normal((batch, size, size, 3)).astype(np.float32)
        seg = (rng.random((batch, size, size)) < 0.3).astype(np.float32)
        tok = np.zeros((batch, KW["context_length"]), np.int32)
        tok[:, :5] = rng.integers(1, 120, (batch, 5))
        tok[:, 5] = KW["vocab_size"] - 1
        out.append((img, seg, tok))
    return out


def test_bce_with_logits_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 17, 19)) * 6).astype(np.float32)
    t = (rng.random((3, 17, 19)) < 0.4).astype(np.float32)
    ref = float(jtrain.bce_with_logits(jnp.asarray(x), jnp.asarray(t)))
    got = float(train.bce_with_logits(to_torch(x), to_torch(t)))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    np.testing.assert_allclose(
        got, float(torch.nn.functional.binary_cross_entropy_with_logits(
            to_torch(x), to_torch(t))), rtol=1e-5)


@pytest.mark.parametrize("lr,t_max,eta_min", [(1e-3, 20000, 1e-4), (1e-3, 7, 1e-4),
                                              (0.05, 3, 0.0)])
def test_cosine_schedule_every_step(lr, t_max, eta_min):
    jf = jtrain.cosine_schedule(lr, t_max, eta_min)
    pf = train.cosine_schedule(lr, t_max, eta_min)
    steps = list(range(0, min(t_max, 40) + 6)) + [t_max - 1, t_max, t_max + 1, 3 * t_max]
    for s in steps:
        np.testing.assert_allclose(pf(s), float(jf(s)), rtol=1e-6, err_msg=f"step {s}")
    assert pf(t_max + 5) == pf(t_max) == pytest.approx(eta_min, abs=1e-9)


def test_foreground_iou_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 9, 11)).astype(np.float32)
    segs = (rng.random((2, 9, 11)) < 0.5).astype(np.float32)
    for lg, sg in ((logits, segs), (np.full_like(logits, -5.0), np.zeros_like(segs))):
        ref = float(jtrain.clipseg_foreground_iou(jnp.asarray(lg), jnp.asarray(sg)))
        got = float(train.clipseg_foreground_iou(to_torch(lg), to_torch(sg)))
        np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert float(train.clipseg_foreground_iou(torch.full((3,), -5.0), torch.zeros(3))) == 1.0


def test_fixed_interval_metrics_match_jax():
    rng = np.random.default_rng(2)
    jtotal = ptotal = None
    for _ in range(3):
        probs = rng.random((2, 13, 15)).astype(np.float32)
        probs[0, :2] = 0.45  # on a grid point
        segs = (rng.random((2, 13, 15)) < 0.4).astype(np.float32)
        jb = jmetrics.threshold_counts(jnp.asarray(probs), jnp.asarray(segs))
        pb = metrics.threshold_counts(to_torch(probs), to_torch(segs))
        for k in ("tp", "fp", "fn", "tn"):
            np.testing.assert_array_equal(pb[k].numpy(), np.asarray(jb[k]))
        jtotal, ptotal = jmetrics.accumulate(jtotal, jb), metrics.accumulate(ptotal, pb)
    ref, got = jmetrics.fixed_interval_metrics(jtotal), metrics.fixed_interval_metrics(ptotal)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_perfect_prediction_metrics():
    segs = torch.zeros(1, 8, 8)
    segs[0, 2:5, 3:6] = 1
    out = metrics.fixed_interval_metrics(metrics.threshold_counts(segs.clone(), segs))
    assert out["fgiou_0.5"] == 1.0 and out["ap"] == pytest.approx(1.0)


@pytest.fixture(scope="module")
def pair():
    """The JAX model and the weights its trainer starts from (``model.init``,
    as ``create_clipseg_state`` draws them, jitted)."""
    img, _, tok = _batches(1)[0]
    jm = jclipseg.CLIPDensePredT(clip_cfg=jmodel.CLIPConfig(**KW), **MKW)
    v = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(img), jnp.asarray(tok))
    return jm, jax.tree_util.tree_map(np.asarray, v)


def _jax_state(jm, params):
    sched = jtrain.cosine_schedule(LR, T_MAX, ETA_MIN)
    tx = optax.masked(optax.adamw(sched, weight_decay=1e-2), jtrain._decoder_mask(params))
    return jtrain.ClipSegTrainState.create(apply_fn=jm.apply, params=params, tx=tx,
                                           lr_fn=sched)


def test_state_trains_the_decoder_only(pair):
    jm, v = pair
    model = load_flax_variables(CLIPDensePredT(clip_cfg=CLIPConfig(**KW), **MKW), v)
    state = train.create_clipseg_state(model, lr=LR, t_max=T_MAX, eta_min=ETA_MIN)
    in_opt = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    for name, p in model.named_parameters():
        tower = name.startswith("clip.")
        assert p.requires_grad != tower and (id(p) in in_opt) != tower, name
    group = state.optimizer.param_groups[0]
    assert isinstance(state.optimizer, torch.optim.AdamW)
    assert group["weight_decay"] == 1e-2 and group["lr"] == pytest.approx(LR)


def _port_state(v):
    model = load_flax_variables(CLIPDensePredT(clip_cfg=CLIPConfig(**KW), **MKW), v)
    return train.create_clipseg_state(model, lr=LR, t_max=T_MAX, eta_min=ETA_MIN)


def _decoder(tree):
    return {k: a for k, a in flat(tree).items() if not k.startswith("clip/")}


def test_first_step_gradients_match_jax(pair):
    jm, v = pair
    img, seg, tok = _batches(1, seed=10)[0]

    def loss_fn(params):
        (logits,) = jm.apply({"params": params}, jnp.asarray(img), jnp.asarray(tok))
        return jtrain.bce_with_logits(logits[..., 0], jnp.asarray(seg))

    ref = _decoder(jax.jit(jax.grad(loss_fn))(v["params"]))
    state = _port_state(v)
    step = train.make_clipseg_train_step()
    step(state, to_torch(img), to_torch(seg), torch.from_numpy(tok))
    assert all(p.grad is None for p in state.model.clip.parameters())
    grads = {k: p.grad for k, p in state.model.named_parameters() if p.requires_grad}
    got = _decoder(flax_from_state_dict(state.model, grads)["params"])
    assert set(got) == set(ref) and len(ref) > 20
    for path, r in ref.items():
        np.testing.assert_allclose(got[path], r, rtol=0,
                                   atol=1e-4 * np.abs(r).max() + 1e-12, err_msg=path)


def test_adamw_matches_optax_on_the_same_gradients(pair):
    jm, v = pair
    jstate = _jax_state(jm, v["params"])
    state = _port_state(v)
    rng = np.random.default_rng(3)
    names = dict(state.model.named_parameters())
    for _ in range(3):
        jgrads = jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(a.shape) * 1e-2).astype(np.float32), v["params"])
        # JAX's tower takes zero gradients (stop_gradient); its mask leaves them
        jgrads["clip"] = jax.tree_util.tree_map(np.zeros_like, jgrads["clip"])
        jstate = jstate.apply_gradients(grads=jgrads)
        grads = flat(jgrads)
        for key, p in names.items():
            if p.requires_grad:
                p.grad = to_torch(grads[flat_path(state.model, key)])
        state.apply_gradients()
        assert state.lr_fn(state.step) == pytest.approx(float(jstate.lr_fn(jstate.step)),
                                                        rel=1e-6)
    got, want = flat(flax_from_state_dict(state.model)["params"]), flat(jstate.params)
    for path, ref in want.items():
        np.testing.assert_allclose(got[path], ref, rtol=1e-6, atol=1e-7, err_msg=path)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_jax(pair, n_steps):
    jm, v = pair
    batches = _batches(n_steps, seed=10)
    jstate = _jax_state(jm, v["params"])
    jstep = jax.jit(jtrain.make_clipseg_train_step(jm))
    state = _port_state(v)
    model = state.model
    step = train.make_clipseg_train_step()
    tower_before = {k: t.clone() for k, t in model.clip.state_dict().items()}
    reset_launch_counts()
    for img, seg, tok in batches:
        jstate, jaux = jstep(jstate, *(jnp.asarray(a) for a in (img, seg, tok)))
        state, aux = step(state, to_torch(img), to_torch(seg), torch.from_numpy(tok))
        np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-5)
        np.testing.assert_allclose(aux["lr"], float(jaux["lr"]), rtol=1e-6)
    assert launch_counts()["csa_attention"] == 0  # CPU tensors: the plain version
    assert state.step == n_steps == int(jstate.step)
    assert all(torch.equal(t, tower_before[k]) for k, t in model.clip.state_dict().items())
    j_before = flat(v["params"])
    want = flat(jstate.params)
    for path, ref in want.items():
        if path.startswith("clip/"):
            np.testing.assert_array_equal(ref, j_before[path], err_msg=path)
    got = flat(flax_from_state_dict(model)["params"])
    assert set(got) == set(want)
    dec = [p for p in want if not p.startswith("clip/")]
    diff = np.concatenate([np.abs(got[p] - want[p]).ravel() for p in dec])
    assert diff.max() <= 2 * LR * n_steps
    assert np.quantile(diff, 0.99) <= 1e-2 * LR * n_steps
    assert sum(not np.array_equal(want[p], j_before[p]) for p in dec) == len(dec)
