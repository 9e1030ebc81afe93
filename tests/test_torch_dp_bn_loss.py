"""Data parallel on 2 gloo ranks on the CPU (``egm_unet_torch/parallel``):
sync-BN, the global-batch criterion and the eval reduction against one
process on the whole batch, and the host-side pieces of the data split
(``rank_rows``, ``shard_batch``, the loader's rows and shards, the
augmentation's rows, the writers of rank 0).

One spawn of 2 ranks serves every check of the group (about 6 s).
Tolerances: BatchNorm in float64, outputs, statistics and gradients 1e-12
relative; the criterion in float32, its value 1e-5 relative and its
gradients 1e-6 of their largest; the eval confusion matrix exactly, its
dice 1e-6."""

import functools

import numpy as np
import pytest
import torch

from egm_unet_torch import losses as L
from egm_unet_torch import metrics as M
from egm_unet_torch.data.device_aug import draw_params
from egm_unet_torch.data.loader import BatchLoader
from egm_unet_torch.nn.layers import BatchNorm
from egm_unet_torch.parallel import launch, rank_rows, shard_batch, shard_superbatch
from egm_unet_torch.utils.checkpoint import CheckpointManager
from egm_unet_torch.utils.logging import MetricLogger, ResultsWriter

from tests.torch_dist_util import bn_loss_eval

WORLD = 2


def bn_case():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 6, 6, 5)) * rng.uniform(0.5, 3, 5) + rng.normal(0, 2, 5)
    return (x, rng.uniform(0.5, 1.5, 5), rng.normal(0, 0.2, 5),
            rng.standard_normal(x.shape))


def loss_case():
    rng = np.random.default_rng(1)
    out = rng.standard_normal((4, 16, 16, 2)).astype(np.float32) * 2
    aux = rng.standard_normal((4, 16, 16, 2)).astype(np.float32) * 2
    targets = rng.integers(0, 2, (4, 16, 16)).astype(np.int64)
    # ignored pixels spread unevenly: most on rank 0's rows
    ignore = rng.random((4, 16, 16)) < np.array([0.4, 0.3, 0.02, 0.0])[:, None, None]
    targets[ignore] = 255
    return out, aux, targets


def eval_case():
    rng = np.random.default_rng(2)
    return [(rng.standard_normal((1, 12, 12, 2)).astype(np.float32),
             rng.integers(0, 2, (1, 12, 12)).astype(np.int64)) for _ in range(5)]


@functools.lru_cache(maxsize=None)
def ranks():
    return launch(bn_loss_eval, WORLD, "gloo", bn_case(), loss_case(), eval_case())


@functools.lru_cache(maxsize=None)
def bn_reference():
    x, scale, bias, w = (torch.from_numpy(a) for a in bn_case())
    bn = BatchNorm(x.shape[-1]).double()
    with torch.no_grad():
        bn.scale.copy_(scale)
        bn.bias.copy_(bias)
    x = x.clone().requires_grad_(True)
    with torch.enable_grad():
        y = bn(x)
        (y * w).sum().backward()
    return {"y": y.detach().numpy(), "gx": x.grad.numpy(), "gscale": bn.scale.grad.numpy(),
            "gbias": bn.bias.grad.numpy(), "mean": bn.mean.numpy(), "var": bn.var.numpy()}


def test_sync_bn_outputs_and_running_stats():
    got = [r["bn"] for r in ranks()]
    ref = bn_reference()
    np.testing.assert_allclose(np.concatenate([g["y"] for g in got]), ref["y"],
                               rtol=1e-12, atol=1e-12)
    for g in got:  # every rank holds the global batch's statistics
        np.testing.assert_allclose(g["mean"], ref["mean"], rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(g["var"], ref["var"], rtol=1e-12, atol=1e-12)
        # one all-reduce forward, one backward
        assert g["collectives"] == 2


def test_sync_bn_gradients():
    got = [r["bn"] for r in ranks()]
    ref = bn_reference()
    np.testing.assert_allclose(np.concatenate([g["gx"] for g in got]), ref["gx"],
                               rtol=1e-12, atol=1e-12 * np.abs(ref["gx"]).max())
    # scale and bias keep this rank's sums: the gradient all-reduce adds them
    # once, and their sum over the ranks is the whole batch's gradient
    for key in ("gscale", "gbias"):
        np.testing.assert_allclose(got[0][key] + got[1][key], ref[key], rtol=1e-12,
                                   atol=1e-12)
        assert not np.allclose(got[0][key], ref[key])


@functools.lru_cache(maxsize=None)
def loss_reference():
    out, aux, targets = (torch.from_numpy(a) for a in loss_case())
    out, aux = out.clone().requires_grad_(True), aux.clone().requires_grad_(True)
    with torch.enable_grad():
        loss = L.criterion({"out": out, "aux": aux}, targets, L.default_loss_weight(2), 2)
        loss.backward()
    return loss.item(), out.grad.numpy(), aux.grad.numpy()


def test_criterion_parts_sum_to_the_global_loss():
    loss, _, _ = loss_reference()
    parts = [r["loss"]["part"] for r in ranks()]
    assert sum(parts) == pytest.approx(loss, rel=1e-5)
    # the mean of each half's own criterion is another number: the weighted
    # CE's denominator and the first target are the global batch's
    out, aux, targets = (torch.from_numpy(a) for a in loss_case())
    halves = [L.criterion({"out": out[s], "aux": aux[s]}, targets[s],
                          L.default_loss_weight(2), 2).item()
              for s in (slice(0, 2), slice(2, 4))]
    assert abs(sum(halves) / 2 - loss) > 0.1 * loss


def test_criterion_gradients_every_row():
    _, gout, gaux = loss_reference()
    got = [r["loss"] for r in ranks()]
    for key, ref in (("gout", gout), ("gaux", gaux)):
        np.testing.assert_allclose(np.concatenate([g[key] for g in got]), ref,
                                   rtol=0, atol=1e-6 * np.abs(ref).max())


def test_eval_reduction_matches_one_process():
    confmat, dice = M.confmat_init(2), M.dice_init()
    for logits, tg in eval_case():
        logits, tg = torch.from_numpy(logits), torch.from_numpy(tg)
        confmat = M.confmat_update(confmat, tg, logits.argmax(dim=-1))
        dice = M.dice_update(dice, logits, tg)
    for r in ranks():
        np.testing.assert_array_equal(r["eval"]["confmat"], confmat.numpy())
        assert r["eval"]["count"] == 5
        assert r["eval"]["dice"] == pytest.approx(float(dice.value), abs=1e-6)


@pytest.mark.parametrize("batch,world,accum", [(8, 2, 1), (8, 2, 2), (12, 3, 2),
                                               (16, 4, 4), (4, 1, 1)])
def test_rank_rows_cover_each_microbatch_once(batch, world, accum):
    rows = [rank_rows(batch, r, world, accum) for r in range(world)]
    assert sorted(np.concatenate(rows).tolist()) == list(range(batch))
    mb = batch // accum
    for i in range(accum):
        # rank 0 holds the first row of every microbatch
        assert i * mb in rows[0]
        for r in range(world):
            local = rows[r][i * mb // world:(i + 1) * mb // world]
            assert np.all((local >= i * mb) & (local < (i + 1) * mb))


def test_rank_rows_refuses_an_uneven_split():
    with pytest.raises(ValueError):
        rank_rows(6, 0, 2, 2)


class _Group:
    def __init__(self, rank, world):
        self.rank, self.world = rank, world


def test_shard_batch_and_superbatch_take_the_rank_rows():
    x = np.arange(8 * 3).reshape(8, 3)
    t = torch.arange(8)
    xs, ts = shard_batch(_Group(1, 2), x, t, accum=2)
    np.testing.assert_array_equal(xs, x[[2, 3, 6, 7]])
    assert ts.tolist() == [2, 3, 6, 7]
    assert shard_batch(None, x) is x
    k = np.stack([x, x + 100])
    np.testing.assert_array_equal(shard_superbatch(_Group(0, 2), k), k[:, :4])


class _Numbers:
    def __len__(self):
        return 11

    def __getitem__(self, i):
        return np.full((2,), i), np.full((2,), i)


def test_loader_rows_and_shards():
    whole = list(BatchLoader(_Numbers(), 4, seed=3))
    parts = [list(BatchLoader(_Numbers(), 4, seed=3, rows=rank_rows(4, r, 2)))
             for r in range(2)]
    assert len(BatchLoader(_Numbers(), 4, rows=rank_rows(4, 0, 2))) == len(whole) == 2
    for b, (images, _) in enumerate(whole):
        np.testing.assert_array_equal(np.concatenate([parts[0][b][0], parts[1][b][0]]),
                                      images)
    # eval: whole batches in turn, the short last one included
    val = [list(BatchLoader(_Numbers(), 2, shuffle=False, drop_last=False,
                            shard=(r, 2))) for r in range(2)]
    assert [len(v) for v in val] == [3, 3]
    firsts = sorted(int(b[0][0, 0]) for v in val for b in v)
    assert firsts == [0, 2, 4, 6, 8, 10]


def test_draw_params_rows_are_the_global_draws():
    kw = dict(b=8, short=96, crop_size=64, min_size=48, max_size=115)
    whole = draw_params(torch.Generator().manual_seed(5), **kw)
    rows = rank_rows(8, 1, 2, accum=2)
    mine = draw_params(torch.Generator().manual_seed(5), **kw, rows=torch.from_numpy(rows))
    for k in whole:
        assert torch.equal(mine[k], whole[k][torch.from_numpy(rows)])


def test_writers_of_other_ranks_write_nothing(tmp_path, capsys):
    ckpt = CheckpointManager(str(tmp_path / "save"), period=1, writer=False)
    assert ckpt.maybe_save(0, 2, state=None, dice=0.5) == ["best"]
    assert not (tmp_path / "save").exists()
    ResultsWriter(str(tmp_path / "r.txt"), writer=False).write_epoch(0, 1.0, 0.1, "b", 0.5)
    assert not (tmp_path / "r.txt").exists()
    logger = MetricLogger(writer=False)
    assert list(logger.log_every([1, 2], 1, "h")) == [1, 2]
    assert capsys.readouterr().out == ""
