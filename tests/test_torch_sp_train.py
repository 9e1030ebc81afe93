"""Spatial parallelism on a 1 x 2 grid of gloo ranks on the CPU (the image
rows of every map split over 2 spatial ranks: ``parallel/halo.py`` and the
row-split ops, BatchNorms, losses and steps), against the JAX package under
``get_mesh_sp(n_data=1, n_spatial=2)`` on the conftest's CPU mesh (GSPMD's
halos) and against the port's one-process step on the whole images.

Cases, at base_c 8: the eval forward of egm_unet at 64 px and of the
vanilla unet at 72 px (9 rows at the bottleneck, 4 and 5 a rank: the
decoder's odd pad lands on rank 1 only), on
``torch_port_util.random_variables``; one train step of the unet at 72 px
in the configuration of the JAX package's own
``test_spatial_train_step_equals_single_device`` (its initialisation,
``synthetic_tp_batch``, lr 0.02: against both); and egm_unet at 64 px in
``tests/test_torch_dp_train.py``'s configuration (random_variables, lr
5e-4): batch 4, ``make_train_step_accum(2)`` at batch 8 and stage remat at
batch 4 (the recomputed stages fetch their halos again), against the
one-process step, which ``tests/test_torch_train.py`` and
``tests/test_torch_train_accum.py`` hold to JAX.  (A JAX egm_unet step
under the spatial mesh takes about 75 s to compile on this CPU with a cold
cache, the unet's a fraction of it; on the random_variables weights JAX's
float32 egm_unet step under the mesh parts from its own one-device step by
4e-4 in the parameters, the float32 ill-conditioning
``tests/test_torch_train.py`` describes, and in float64 the two agree to
3e-8.)  And the MCA pools regression of
``tests/test_spatial_parallel.py::test_mca_pools_spatial_sharding``;
``fetch_rows``'s gradient against autograd through the whole map, with a
halo taller than a slab; the row-split ``conv2d`` on both of its paths
(strips across the slab's edges; the whole slab with its halo where the
slab is shorter than twice the padding) against the whole map's conv,
forward and gradients.  One spawn of 2 ranks runs them all, in a thread
of the test process while the JAX programs compile there.

Bounds: logits 1e-4 (absolute and relative), the loss 1e-5 relative, the
parameters and BatchNorm statistics after the step 1e-4 (max abs
difference), the pools 1e-6, ``fetch_rows`` exactly and the convs to 1e-12
(float64)."""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egm_unet_tpu.data.synthetic import synthetic_tp_batch
from egm_unet_tpu.engine import make_train_step as j_make_train_step
from egm_unet_tpu.engine import warmup_poly_schedule as j_schedule
from egm_unet_tpu.engine.state import TrainState as JTrainState
from egm_unet_tpu.engine.state import sgd_torch as j_sgd_torch
from egm_unet_tpu.models import create_model as j_create_model
from egm_unet_tpu.ops.pooling import avg_pool2d as j_avg, max_pool2d as j_max
from egm_unet_tpu.ops.pooling import min_pool2d as j_min
from egm_unet_tpu.parallel import get_mesh_sp, shard_batch_spatial
from egm_unet_torch.engine import make_train_step, make_train_step_accum
from egm_unet_torch.parallel import launch
from egm_unet_torch.utils import flax_from_state_dict, load_flax_variables

from tests.torch_dist_util import sp_cases
from tests.torch_port_util import random_variables
from tests.torch_train_util import (train_test_env,  # noqa: F401 (autouse fixture)
                                    BASE_C, SCHED, batches, flat, port_state)

FWD = {"egm_unet-64": ("egm_unet", 64), "unet-72": ("unet", 72)}
# name -> (model, batch, accum, remat, size)
STEPS = {"unet_jax_config": ("unet", 2, 1, False, 72),
         "egm_unet": ("egm_unet", 4, 1, False, 64),
         "accum2": ("egm_unet", 8, 2, False, 64),
         "remat": ("egm_unet", 4, 1, "stage", 64)}
JAX_CASE = "unet_jax_config"
JAX_SCHED = dict(base_lr=0.02, num_step=20, epochs=2)  # test_spatial_parallel.py's


@functools.lru_cache(maxsize=None)
def variables(name):
    return random_variables(j_create_model(name, base_c=BASE_C),
                            jnp.zeros((2, 32, 32, 3)), train=True)


@functools.lru_cache(maxsize=None)
def jax_init_variables(name, size):
    """The JAX package's own initialisation (``create_train_state`` with
    key 0), jitted."""
    model = j_create_model(name, base_c=BASE_C)
    v = jax.jit(lambda k: model.init(k, jnp.zeros((1, size, size, 3)), train=True))(
        jax.random.key(0))
    return jax.tree_util.tree_map(np.asarray, dict(v))


def step_variables(case):
    name, *_, size = STEPS[case]
    return jax_init_variables(name, size) if case == JAX_CASE else variables(name)


def step_sched(case):
    return JAX_SCHED if case == JAX_CASE else SCHED


def port_step_state(case):
    from egm_unet_torch.engine import create_train_state, warmup_poly_schedule
    from egm_unet_torch.models import create_model

    name, _, _, remat, _ = STEPS[case]
    model = load_flax_variables(create_model(name, base_c=BASE_C, fold_bn=False,
                                             remat=remat), step_variables(case))
    return create_train_state(model, warmup_poly_schedule(**step_sched(case)))


def fwd_images(case):
    _, size = FWD[case]
    return np.random.default_rng(3).standard_normal((2, size, size, 3)).astype(np.float32)


def step_data(case):
    _, batch, _, _, size = STEPS[case]
    if case == JAX_CASE:
        return tuple(np.asarray(a) for a in synthetic_tp_batch(batch, size))
    return batches(n=1, seed=7, batch=batch, size=size)[0]


def pools_input():
    return np.random.RandomState(0).rand(2, 32, 32, 16).astype(np.float32)


def fetch_cases():
    """(x, a, b, fill, w): float64 maps of 6 rows (3 a rank); a halo of 5
    rows each side (taller than a slab, partly outside the image), and the
    uneven requests of a 2x2 / 2 pool of a map of 7 rows (3 and 4 a rank;
    the pooled rank 0 reads row 3 of rank 1)."""
    rng = np.random.default_rng(5)
    out = []
    for h, a, b, fill in ((6, [-5, -2], [8, 11], 0.0), (7, [0, 2], [2, 6], -1.5)):
        x = rng.standard_normal((2, h, 4))
        w = [rng.standard_normal((2, b[r] - a[r], 4)) for r in range(2)]
        out.append((x, a, b, fill, w))
    return out


# (height, padding, dilation): 3x3 on 12 rows a rank (strips), dilation 4
# on 6 rows a rank (2 * 4 > 6: the whole slab with its halo)
CONVS = ((24, 1, 1), (12, 4, 4))


def conv_cases():
    rng = np.random.default_rng(6)
    return [(rng.standard_normal((2, h, 5, 3)), rng.standard_normal((3, 3, 3, 4)), p, d,
             rng.standard_normal((2, h, 5, 4))) for h, p, d in CONVS]


def sp_launch():
    fwd = [(FWD[c][0], port_state(FWD[c][0], variables(FWD[c][0])).model.state_dict(),
            fwd_images(c)) for c in FWD]
    steps = [(name, port_step_state(c).model.state_dict(), *step_data(c), accum, remat,
              step_sched(c)) for c, (name, _, accum, remat, _) in STEPS.items()]
    ranks = launch(sp_cases, 2, "gloo", fwd, steps, fetch_cases(), pools_input(),
                   conv_cases(), grid=(1, 2))
    return ranks


@functools.lru_cache(maxsize=None)
def sp_future():
    return ThreadPoolExecutor(1).submit(sp_launch)


def sp_runs():
    return sp_future().result()


def rows_joined(key, i, field):
    """Both ranks' rows of an output, joined along H."""
    return np.concatenate([r[key][i][field] for r in sp_runs()], axis=1)


@functools.lru_cache(maxsize=None)
def jax_forward(case):
    name, _ = FWD[case]
    model = j_create_model(name, base_c=BASE_C)
    fn = jax.jit(lambda v, x: model.apply(v, x, train=False)["out"])
    mesh = get_mesh_sp(n_data=1, n_spatial=2, devices=jax.devices()[:2])
    with jax.set_mesh(mesh):
        return np.asarray(fn(variables(name), shard_batch_spatial(mesh, jnp.asarray(
            fwd_images(case)))))


@functools.lru_cache(maxsize=None)
def jax_step():
    """``test_spatial_train_step_equals_single_device``'s step under a 1 x 2
    spatial mesh."""
    name = STEPS[JAX_CASE][0]
    v, sched = step_variables(JAX_CASE), j_schedule(**JAX_SCHED)
    state = JTrainState.create(apply_fn=j_create_model(name, base_c=BASE_C).apply,
                               params=v["params"], batch_stats=v["batch_stats"],
                               tx=j_sgd_torch(sched), lr_fn=sched)
    mesh = get_mesh_sp(n_data=1, n_spatial=2, devices=jax.devices()[:2])
    with jax.set_mesh(mesh):
        state, aux = jax.jit(j_make_train_step(num_classes=2))(
            state, *shard_batch_spatial(mesh, *(jnp.asarray(a) for a in step_data(
                JAX_CASE))))
    return float(aux["loss"]), flat(state.params), flat(state.batch_stats)


def port_one_process(case):
    _, _, accum, _, _ = STEPS[case]
    state = port_step_state(case)
    step = make_train_step_accum(accum) if accum > 1 else make_train_step()
    images, targets = step_data(case)
    state, aux = step(state, torch.from_numpy(images), torch.from_numpy(targets))
    tree = flax_from_state_dict(state.model)
    return aux["loss"].item(), flat(tree["params"]), flat(tree["batch_stats"])


def sp_trees(case):
    """Each rank's (loss, flat params, flat stats) after the step."""
    i = list(STEPS).index(case)
    model = port_step_state(case).model
    out = []
    for rank in sp_runs():
        r = rank["step"][i]
        tree = flax_from_state_dict(model, {k: torch.from_numpy(v)
                                            for k, v in r["state"].items()})
        out.append((r["loss"], flat(tree["params"]), flat(tree["batch_stats"])))
    return out


def assert_trees(port, ref, what):
    assert set(port) == set(ref)
    worst = max(float(np.abs(port[k] - ref[k]).max()) for k in ref)
    assert worst < 1e-4, f"{what}: max |diff| {worst}"


def test_row_split_step_matches_jax_spatial_mesh():
    sp_future()  # the ranks run while JAX compiles (this test comes first)
    loss, params, stats = jax_step()
    for got_loss, got_params, got_stats in sp_trees(JAX_CASE):
        assert got_loss == pytest.approx(loss, rel=1e-5)
        assert_trees(got_params, params, "params")
        assert_trees(got_stats, stats, "stats")


@pytest.mark.parametrize("case", ["unet-72"])
def test_row_split_forward_matches_jax_spatial_mesh(case):
    sp_future()
    ref = jax_forward(case)
    got = rows_joined("fwd", list(FWD).index(case), "logits")
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", list(FWD))
def test_row_split_forward_matches_one_process(case):
    name, _ = FWD[case]
    model = port_state(name, variables(name)).model.eval()
    with torch.no_grad():
        ref = model(torch.from_numpy(fwd_images(case)))["out"].numpy()
    got = rows_joined("fwd", list(FWD).index(case), "logits")
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", list(STEPS))
def test_row_split_step_matches_one_process(case):
    loss, params, stats = port_one_process(case)
    for got_loss, got_params, got_stats in sp_trees(case):
        assert got_loss == pytest.approx(loss, rel=1e-5)
        assert_trees(got_params, params, f"{case} params")
        assert_trees(got_stats, stats, f"{case} stats")


def test_spatial_ranks_stay_identical():
    """Both ranks make the same update from the same reduced gradients."""
    for case in STEPS:
        (l0, p0, s0), (l1, p1, s1) = sp_trees(case)
        assert l0 == l1
        for k in p0:
            np.testing.assert_array_equal(p0[k], p1[k], err_msg=f"{case} {k}")
        for k in s0:
            np.testing.assert_array_equal(s0[k], s1[k], err_msg=f"{case} {k}")


def test_halo_collectives_per_step():
    """The halos and spatial sums run on the spatial group, twice as many
    with accum 2, more again where remat recomputes the stages; the
    BatchNorm, loss and gradient reductions on the grid's whole group."""
    _, plain, accum2, remat = sp_runs()[0]["step"]
    assert plain["halo_collectives"] > 0 and plain["reduce_collectives"] > 0
    # one host gather of the row counts a step, the rest per microbatch
    assert accum2["halo_collectives"] == 2 * plain["halo_collectives"] - 1
    assert remat["halo_collectives"] > plain["halo_collectives"]
    assert remat["reduce_collectives"] > plain["reduce_collectives"]


def test_mca_pools_row_split_match_jax():
    """The regression of test_mca_pools_spatial_sharding: max - min and the
    count-include-pad average of the 3x3 pools at the image's edge rows and
    at the rank boundary, no padding leaking from one into another."""
    x = jnp.asarray(pools_input())
    ref = (j_max(x, 3, 1, 1) - j_min(x, 3, 1, 1), j_avg(x, 3, 1, 1))
    for i, r in enumerate(ref):
        got = np.concatenate([rank["pools"][i] for rank in sp_runs()], axis=1)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, np.asarray(r), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("i", [0, 1], ids=["halo_taller_than_slab", "pool_rows"])
def test_fetch_rows_backward_matches_autograd_through_the_whole_map(i):
    """Each rank's fetched rows and the gradient of ``sum_r out_r * w_r``
    with respect to its rows, against the whole map padded with the fill,
    sliced, and differentiated by autograd."""
    x, a, b, fill, w = fetch_cases()[i]
    h = x.shape[1]
    pad = max(0, -min(a)), max(0, max(b) - h)
    whole = torch.from_numpy(x).requires_grad_(True)
    padded = torch.nn.functional.pad(whole, (0, 0, *pad), value=fill)
    outs = [padded[:, a[r] + pad[0]:b[r] + pad[0]] for r in range(2)]
    sum((o * torch.from_numpy(w[r])).sum() for r, o in enumerate(outs)).backward()
    grads = []
    for r, rank in enumerate(sp_runs()):
        np.testing.assert_array_equal(rank["fetch"][i]["out"], outs[r].detach().numpy())
        grads.append(rank["fetch"][i]["grad"])
    np.testing.assert_allclose(np.concatenate(grads, axis=1), whole.grad.numpy(),
                               rtol=1e-15, atol=1e-15)


@pytest.mark.parametrize("i", [0, 1], ids=["strips", "whole_slab"])
def test_row_split_conv_matches_the_whole_map(i):
    x, w, padding, dilation, g = conv_cases()[i]
    xt, wt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    y = torch.nn.functional.conv2d(xt.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1),
                                   padding=padding, dilation=dilation).permute(0, 2, 3, 1)
    (y * torch.from_numpy(g)).sum().backward()
    runs = [rank["conv"][i] for rank in sp_runs()]
    tol = dict(rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.concatenate([r["out"] for r in runs], axis=1),
                               y.detach().numpy(), **tol)
    np.testing.assert_allclose(np.concatenate([r["gx"] for r in runs], axis=1),
                               xt.grad.numpy(), **tol)
    # each rank's weight gradient is its rows' part; the parts sum to it
    np.testing.assert_allclose(sum(r["gw"] for r in runs), wt.grad.numpy(), **tol)
