"""The frozen yardstick: counts on hand-worked shapes, the peaks, the kernel
name lists, the traffic generator's determinism, the comparison."""

import math

import numpy as np
import pytest
import torch

from port_bench import roofline
from port_bench.reference import pipeline
from port_bench.roofline import sites
from port_bench.traffic import generator


def test_conv3x3_counts_by_hand():
    # B=1, 2x2 map, C=3 -> Co=4 in bf16: x 24 B, kernel 9*3*4*2 = 216 B,
    # float32 bias 16 B, out 32 B; 2*4 pixels*27 taps*4 outputs = 864 FLOPs
    s = sites.conv3x3(1, 2, 2, 3, 4, "bfloat16")
    assert s.nbytes == 24 + 216 + 16 + 32
    assert s.flops == 864


def test_up_concat_and_mca_counts_by_hand():
    # x2 1x4x4x2, x1 1x2x2x3 -> Co=1 in float32
    s = sites.up_concat(1, 4, 4, 2, 3, 1, "float32")
    assert s.nbytes == 16 * 2 * 4 + 4 * 3 * 4 + 9 * 5 * 1 * 4 + 4 + 16 * 4
    assert s.flops == 2 * 16 * 9 * 5
    m = sites.mca(2, 3, 5, 8, "bfloat16")
    assert m.nbytes == 2 * (2 * 3 * 5 * 8 * 2) + 4 * 2 * (3 + 5 + 8)
    assert m.flops == 40 * 2 * 3 * 5 * 8


def test_csa_counts_by_hand():
    (s,) = sites.csa_sites(2, 5, 8, 2, 1, "float32")
    assert s.nbytes == 4 * 2 * 5 * 8 * 4
    assert s.flops == 6 * 2 * 2 * 25 * 4


@pytest.mark.parametrize("model,counts", [
    ("egm_unet", {"conv3x3_gemm": 18, "mca_fused": 4, "up_concat_conv": 4}),
    ("grfb_unet", {"conv3x3_gemm": 14, "up_concat_conv": 4}),
])
def test_unet_site_lists(model, counts):
    got = {}
    for s in sites.unet_sites(model, 32, 8, (576, 768), "bfloat16"):
        got[s.op] = got.get(s.op, 0) + 1
    assert got == counts


def test_bounds_match_the_recorded_kernel_bounds():
    """The bounds PERF.md's kernel table gives at batch 8, bf16, 576x768."""
    s = sites.unet_sites("egm_unet", 32, 8, (576, 768), "bfloat16")
    by = lambda op: 1e3 * sites.bound_of([x for x in s if x.op == op], "bfloat16")  # noqa: E731
    assert by("mca_fused") == pytest.approx(0.123, abs=5e-4)
    assert by("conv3x3_gemm") == pytest.approx(0.879, abs=5e-4)
    assert by("up_concat_conv") == pytest.approx(0.548, abs=5e-4)
    csa = sites.csa_sites(32, 485, 768, 12, 1, "float32")
    assert 1e3 * sites.bound_of(csa, "float32") == pytest.approx(0.518, abs=5e-4)


def test_bound_picks_the_larger_and_the_dtype_peak():
    assert roofline.bound_s(3.35e12, 1.0, "bfloat16") == pytest.approx(1.0)
    assert roofline.bound_s(1.0, 67e12, "float32") == pytest.approx(1.0)
    assert roofline.bound_s(1.0, 989e12, "bfloat16") == pytest.approx(1.0)


def test_kernel_names_union():
    names = roofline.kernel_names("conv3x3_gemm", "up_concat_conv")
    assert {"conv3x3_mma_kernel", "upconv_mma_kernel", "igemm3x3_kernel"} <= names
    with pytest.raises(FileNotFoundError):
        roofline.kernel_names("no_such_operation")


def test_frames_are_deterministic_for_a_seed():
    mix = {"frames": [[40, 60, 0.5], [60, 40, 0.5]], "pool": 4}
    a, b = generator.frames(mix, 2 ** 33 + 5), generator.frames(mix, 2 ** 33 + 5)
    c = generator.frames(mix, 7)
    assert [f.shape for f in a] == [(40, 60, 3)] * 2 + [(60, 40, 3)] * 2
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))


def test_groups_same_work_for_every_seed():
    mix = {"frames": [[40, 60, 1.0]], "pool": 8, "batch": 3, "pool_batches": 4}
    a, b = generator.groups(mix, 1, "batch", "pool_batches"), generator.groups(
        mix, 2 ** 33 + 1, "batch", "pool_batches")
    assert [len(g) for g in a] == [len(g) for g in b] == [3] * 4
    assert all(len(set(g)) == 3 and 0 <= min(g) and max(g) < 8 for g in a + b)
    assert a == generator.groups(mix, 1, "batch", "pool_batches") and a != b


def test_mask_gap_by_hand():
    margin = torch.tensor([[2.0, -1.0], [0.5, -0.1]])
    served = torch.tensor([[True, True], [True, False]])  # flips the -1.0 pixel
    r = pipeline.combine([pipeline.mask_gap(margin, served)])
    assert r["flips"] == 1 and r["gap"] == 1.0
    rms = math.sqrt((4 + 1 + 0.25 + 0.01) / 4)
    assert r["mask_gap"] == pytest.approx(1.0 / rms)
    same = pipeline.combine([pipeline.mask_gap(margin, margin > 0)])
    assert same["mask_gap"] == 0.0


def test_nearest_pil_index_rule():
    x = torch.arange(4.0)[:, None].repeat(1, 2)
    y = pipeline.nearest_pil(x, (6, 2))
    assert y[:, 0].tolist() == [0.0, 1.0, 1.0, 2.0, 3.0, 3.0]  # floor((i + 0.5) 4 / 6)
