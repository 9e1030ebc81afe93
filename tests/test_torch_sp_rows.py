"""The host side of spatial parallelism, with no processes: ``row_range``'s
split (uneven heights, the JAX test's 6 rows over 4 ranks), the refusal of
heights whose stages leave a rank without rows, ``shard_batch_spatial`` /
``shard_superbatch_spatial`` on a grid's coordinates, the training CLI's
refusals, and the folded graph's refusal of a spatial group (raised before
any collective)."""

import numpy as np
import pytest
import torch

from egm_unet_torch.cli import train as train_cli
from egm_unet_torch.models import create_model
from egm_unet_torch.parallel import (DataGroup, Grid, check_spatial_height, row_range,
                                     shard_batch_spatial, shard_superbatch_spatial,
                                     use_spatial_group)


@pytest.mark.parametrize("height,n,want", [
    (6, 4, [(0, 1), (1, 3), (3, 4), (4, 6)]),
    (9, 2, [(0, 4), (4, 9)]),
    (30, 2, [(0, 15), (15, 30)]),
    (4, 4, [(0, 1), (1, 2), (2, 3), (3, 4)]),
])
def test_row_range_cases(height, n, want):
    assert [row_range(height, r, n) for r in range(n)] == want


def test_row_range_tiles_every_height():
    """The ranges tile [0, H) in order, each floor(H / n) or ceil(H / n)
    rows, for every H >= n up to 200 and n up to 8."""
    for n in range(1, 9):
        for h in range(n, 200):
            ranges = [row_range(h, r, n) for r in range(n)]
            assert ranges[0][0] == 0 and ranges[-1][1] == h
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
            assert {hi - lo for lo, hi in ranges} <= {h // n, -(-h // n)}


def test_row_range_refuses_fewer_rows_than_ranks():
    with pytest.raises(ValueError, match="cannot be split"):
        row_range(3, 0, 4)


def test_check_spatial_height():
    """96 px over 4 ranks leaves 6 rows at the bottleneck (1 or 2 a rank);
    48 px leaves 3, and is refused naming the stage and the least height."""
    check_spatial_height(96, 4)
    check_spatial_height(480, 30)
    with pytest.raises(ValueError, match="stage 4 has 3 rows.*at least 64"):
        check_spatial_height(48, 4)


def grid(d, i, n_data, n_inner):
    return Grid(DataGroup(None, d * n_inner + i, n_data * n_inner),
                DataGroup(None, i, n_inner), DataGroup(None, d, n_data), n_data, n_inner)


def test_shard_batch_spatial_takes_the_data_rows_then_the_image_rows():
    images = np.arange(4 * 33 * 3 * 1).reshape(4, 33, 3, 1)
    targets = torch.arange(4 * 33 * 3).reshape(4, 33, 3)
    for d in range(2):
        for i in range(2):
            x, t = shard_batch_spatial(grid(d, i, 2, 2), images, targets)
            lo, hi = (0, 16) if i == 0 else (16, 33)
            np.testing.assert_array_equal(x, images[2 * d:2 * d + 2, lo:hi])
            assert torch.equal(t, targets[2 * d:2 * d + 2, lo:hi])
    # by microbatch: data rank 1 of 2 holds row 1 of each microbatch of 2
    x = shard_batch_spatial(grid(1, 0, 2, 2), images, accum=2)
    np.testing.assert_array_equal(x, images[[1, 3], 0:16])


def test_shard_superbatch_spatial_keeps_the_step_axis():
    stack = np.arange(3 * 4 * 33 * 2).reshape(3, 4, 33, 2)
    x = shard_superbatch_spatial(grid(0, 1, 2, 2), stack)
    np.testing.assert_array_equal(x, stack[:, 0:2, 16:33])


def test_shard_batch_spatial_refuses_too_small_heights():
    with pytest.raises(ValueError, match="stage"):
        shard_batch_spatial(grid(0, 0, 1, 4), np.zeros((1, 48, 48, 3)))


def test_train_cli_refuses_a_crop_too_small_for_the_spatial_ranks():
    args = ["--device", "cpu", "--synthetic", "--synthetic-size", "24",
            "--mesh-spatial", "2"]
    with pytest.raises(SystemExit) as exc:
        train_cli.main(args)
    assert "--mesh-spatial 2" in str(exc.value.code) and "stage 4" in str(exc.value.code)


@pytest.mark.parametrize("name", ["egm_unet", "unet"])
def test_folded_graph_refuses_a_spatial_group(name):
    """The serving graph does not run row-split (JAX row-splits the
    BatchNorm graph only): a clear ValueError, before any collective."""
    model = create_model(name, base_c=8, generator=torch.Generator().manual_seed(0))
    with torch.no_grad(), use_spatial_group(DataGroup(None, 0, 2), 32):
        with pytest.raises(ValueError, match="folded"):
            model(torch.zeros(1, 16, 32, 3))
