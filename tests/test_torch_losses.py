"""The training losses, the dice metric and the learning-rate schedule against
the JAX package's on the CPU, from the same seeded numpy inputs.

Tolerances (float32): loss values rtol 1e-5, their gradients with respect
to the logits rtol 1e-5 (atol 1e-5 of the largest); the dice state's count
exactly, its value to 1e-6; the schedule to 1e-7 at every step of a
3-epoch x 5-step run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egm_unet_tpu import losses as JL
from egm_unet_tpu import metrics as JM
from egm_unet_tpu.engine.schedule import warmup_poly_schedule as j_schedule
from egm_unet_tpu.ops import stencil as JS
from egm_unet_torch import losses as L
from egm_unet_torch import metrics as M
from egm_unet_torch.engine.schedule import warmup_poly_schedule
from egm_unet_torch.ops import stencil as S
from torch_train_util import train_test_env  # noqa: F401 (autouse fixture)


def _batch(num_classes=2, ignore_share=0.0, seed=0, shape=(2, 16, 20)):
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal(shape + (num_classes,))).astype(np.float32)
    target = rng.integers(0, num_classes, shape).astype(np.int32)
    if ignore_share:
        target[rng.random(shape) < ignore_share] = 255
    return logits, target


def _close(port, ref, rtol=1e-5):
    ref = np.asarray(ref, np.float64)
    port = np.asarray(port, np.float64)
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-30))


LOSSES = {
    "cross_entropy": (lambda x, t: JL.cross_entropy(x, t, JL.default_loss_weight(x.shape[-1])),
                      lambda x, t: L.cross_entropy(x, t, L.default_loss_weight(x.shape[-1]))),
    "cross_entropy_unweighted": (lambda x, t: JL.cross_entropy(x, t),
                                 lambda x, t: L.cross_entropy(x, t)),
    "dice_loss": (lambda x, t: JL.dice_loss(x, JL.build_target(t, x.shape[-1], 255),
                                            multiclass=True, ignore_index=255),
                  lambda x, t: L.dice_loss(x, L.build_target(t, x.shape[-1], 255),
                                           multiclass=True, ignore_index=255)),
    "laplace_loss": (lambda x, t: JL.laplace_loss(x), lambda x, t: L.laplace_loss(x)),
    "lap_loss": (JL.lap_loss, L.lap_loss),
    "sobel_loss": (JL.sobel_loss, L.sobel_loss),
    "criterion": (lambda x, t: JL.criterion({"out": x}, t, JL.default_loss_weight(2)),
                  lambda x, t: L.criterion({"out": x}, t, L.default_loss_weight(2))),
    "criterion_ce_only": (
        lambda x, t: JL.criterion({"out": x}, t, JL.default_loss_weight(2), dice=False),
        lambda x, t: L.criterion({"out": x}, t, L.default_loss_weight(2), dice=False)),
    "criterion_with_aux": (
        lambda x, t: JL.criterion({"out": x, "aux": 0.5 * x[:, ::-1]}, t,
                                  JL.default_loss_weight(2)),
        lambda x, t: L.criterion({"out": x, "aux": 0.5 * x.flip(1)}, t,
                                 L.default_loss_weight(2))),
}


@pytest.mark.parametrize("ignore_share", [0.0, 0.2], ids=["no_ignore", "ignore"])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_value_and_logit_gradient(name, ignore_share):
    jfn, pfn = LOSSES[name]
    logits, target = _batch(ignore_share=ignore_share, seed=len(name))
    ref, gref = jax.value_and_grad(jfn)(jnp.asarray(logits), jnp.asarray(target))
    x = torch.from_numpy(logits).requires_grad_(True)
    val = pfn(x, torch.from_numpy(target))
    val.backward()
    _close(val.item(), ref)
    _close(x.grad.numpy(), gref)


def test_three_class_losses_and_weights():
    assert L.default_loss_weight(3) is None and JL.default_loss_weight(3) is None
    np.testing.assert_array_equal(L.default_loss_weight(2).numpy(),
                                  np.asarray(JL.default_loss_weight(2)))
    logits, target = _batch(num_classes=3, ignore_share=0.1, seed=5)
    ref = JL.criterion({"out": jnp.asarray(logits)}, jnp.asarray(target), None, 3)
    val = L.criterion({"out": torch.from_numpy(logits)}, torch.from_numpy(target), None, 3)
    _close(val.item(), ref)


def test_build_target_and_dice_quirks():
    _, target = _batch(ignore_share=0.3, seed=2)
    for ignore in (255, -100):
        t = target if ignore == 255 else np.minimum(target, 1)
        np.testing.assert_array_equal(
            L.build_target(torch.from_numpy(t), 2, ignore).numpy(),
            np.asarray(JL.build_target(jnp.asarray(t), 2, ignore)))
    # an empty prediction against an empty target: sets_sum 0 -> 2 * inter
    x = np.zeros((2, 4, 4), np.float32)
    x[1, 0, 0] = 0.5
    t = np.zeros((2, 4, 4), np.float32)
    for ignore in (-100, 255):
        _close(L.dice_coeff(torch.from_numpy(x), torch.from_numpy(t), ignore).item(),
               JL.dice_coeff(jnp.asarray(x), jnp.asarray(t), ignore))
    logits, target = _batch(num_classes=3, seed=4)
    probs = torch.softmax(torch.from_numpy(logits), -1)
    onehot = L.build_target(torch.from_numpy(target), 3)
    _close(L.multiclass_dice_coeff(probs, onehot).item(),
           JL.multiclass_dice_coeff(jnp.asarray(probs.numpy()), jnp.asarray(onehot.numpy())))


def test_lap_and_sobel_take_the_first_target_only():
    logits, target = _batch(seed=9)
    other = target.copy()
    other[1:] = 1 - other[1:]
    for fn in (L.lap_loss, L.sobel_loss):
        a = fn(torch.from_numpy(logits), torch.from_numpy(target))
        b = fn(torch.from_numpy(logits), torch.from_numpy(other))
        assert a.item() == b.item()


@pytest.mark.parametrize("shape", [(7, 9), (2, 7, 9), (2, 7, 9, 1)], ids=["hw", "bhw", "bhw1"])
@pytest.mark.parametrize("kernel", ["LAPLACE4", "LAPLACE8", "SOBEL_X", "SOBEL_Y"])
def test_stencils(kernel, shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    ref = JS.stencil2d(jnp.asarray(x), getattr(JS, kernel))
    out = S.stencil2d(torch.from_numpy(x), getattr(S, kernel))
    assert tuple(out.shape) == tuple(ref.shape)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_dice_state_matches():
    js, ps = JM.dice_init(), M.dice_init()
    assert float(ps.value) == 0.0 and int(ps.count) == 0
    for i in range(3):
        logits, target = _batch(ignore_share=0.1 * i, seed=20 + i)
        js = JM.dice_update(js, jnp.asarray(logits), jnp.asarray(target))
        ps = M.dice_update(ps, torch.from_numpy(logits), torch.from_numpy(target))
    assert int(ps.count) == int(js.count) == 3
    assert ps.count.dtype == torch.int32 and ps.cumulative.dtype == torch.float32
    np.testing.assert_allclose(float(ps.value), float(js.value), rtol=0, atol=1e-6)


@pytest.mark.parametrize("warmup", [True, False], ids=["warmup", "no_warmup"])
def test_schedule_every_step(warmup):
    ref = j_schedule(0.02, num_step=5, epochs=3, warmup=warmup)
    mine = warmup_poly_schedule(0.02, num_step=5, epochs=3, warmup=warmup)
    got = [mine(k) for k in range(16)]
    want = [float(ref(k)) for k in range(16)]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    assert got[0] == pytest.approx(0.02 * (1e-3 if warmup else 1.0), rel=1e-6)
    assert got[15] == 0.0


def test_schedule_edge_cases():
    # no decay epochs: warm-up only, then 0; a warm-up of 0 epochs
    for kw in (dict(epochs=1), dict(epochs=2, warmup_epochs=0)):
        ref = j_schedule(0.1, num_step=3, **kw)
        mine = warmup_poly_schedule(0.1, num_step=3, **kw)
        for k in range(7):
            assert mine(k) == pytest.approx(float(ref(k)), abs=1e-7)
    with pytest.raises(ValueError):
        warmup_poly_schedule(0.1, num_step=0, epochs=1)
