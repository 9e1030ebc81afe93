"""egm_unet_torch's device augmentation (``data/device_aug.py``) against the
JAX package's ``augment_batch``: the draws are re-derived from JAX's key as
``augment_batch`` splits it and handed to the port's ``augment_with_params``.

Tolerances: images within 1e-5 absolute in the source's [0, 1] units, that
is after multiplying both sides by the normalization's std (XLA rewrites
the coordinate arithmetic ``(g + o + 0.5) / scale - 0.5`` inside its fused
program and lands up to two float32 ulps away from the port's, which moves
a bilinear blend by up to about 8e-6; dividing by TP-928's std, as small as
0.043, multiplies that by 23); masks equal except where a source
coordinate lies within 1e-4 of an integer, where the two floors may pick
neighbouring pixels (such pixels are counted and must stay rare)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egm_unet_tpu.data.device_aug import augment_batch as jaugment_batch
from egm_unet_torch.data.device_aug import (augment_batch, augment_with_params,
                                            draw_params, source_coords)
from egm_unet_torch.data.transforms import TP_MEAN, TP_STD


def jax_params(key, b, h, w, crop, min_size, max_size):
    """The draws of ``egm_unet_tpu.data.device_aug.augment_batch`` for
    ``key``, as the port's params dict."""
    short = min(h, w)
    k_scale, k_cy, k_cx, k_hf, k_vf = jax.random.split(key, 5)
    sizes = jax.random.randint(k_scale, (b,), min_size, max_size + 1)
    scales = sizes.astype(jnp.float32) / short
    max_oy = jnp.maximum(h * scales - crop, 0.0)
    max_ox = jnp.maximum(w * scales - crop, 0.0)
    oy = jax.random.uniform(k_cy, (b,)) * max_oy
    ox = jax.random.uniform(k_cx, (b,)) * max_ox
    hflip = jax.random.uniform(k_hf, (b,)) < 0.5
    vflip = jax.random.uniform(k_vf, (b,)) < 0.5
    t = lambda a: torch.from_numpy(np.array(a))
    return {"sizes": t(sizes), "oy": t(oy), "ox": t(ox), "hflip": t(hflip),
            "vflip": t(vflip)}


def make_batch(seed, b, h, w):
    rng = np.random.default_rng(seed)
    imgs = rng.random((b, h, w, 3), dtype=np.float32)
    masks = (rng.random((b, h, w)) > 0.6).astype(np.int32)
    return imgs, masks


def near_integer(params, short, crop, tol=1e-4):
    """[B, crop, crop] pixels whose source row or column coordinate lies
    within ``tol`` of an integer."""
    ys, xs = source_coords(params, short, crop)
    ny = (ys - ys.round()).abs() < tol
    nx = (xs - xs.round()).abs() < tol
    return (ny[:, :, None] | nx[:, None, :]).numpy()


@pytest.mark.parametrize("b,h,w,crop,lo,hi,seed", [
    (4, 64, 64, 32, 32, 76, 0),     # the CLI's canvas: src = 2 * crop
    (3, 48, 60, 40, 20, 70, 1),     # non-square sources, scales below the crop
])
def test_matches_jax_augment_batch(b, h, w, crop, lo, hi, seed):
    imgs, masks = make_batch(seed, b, h, w)
    key = jax.random.key(seed + 10)
    ref_i, ref_m = jaugment_batch(key, jnp.asarray(imgs), jnp.asarray(masks),
                                  jnp.asarray(TP_MEAN), jnp.asarray(TP_STD),
                                  crop_size=crop, min_size=lo, max_size=hi)
    params = jax_params(key, b, h, w, crop, lo, hi)
    out_i, out_m = augment_with_params(torch.from_numpy(imgs), torch.from_numpy(masks),
                                       params, TP_MEAN, TP_STD, crop)
    assert out_i.shape == (b, crop, crop, 3) and out_i.dtype == torch.float32
    assert out_m.shape == (b, crop, crop) and out_m.dtype == torch.int32
    np.testing.assert_allclose(out_i.numpy() * TP_STD, np.asarray(ref_i) * TP_STD,
                               rtol=0, atol=1e-5)
    diff = out_m.numpy() != np.asarray(ref_m)
    near = near_integer(params, min(h, w), crop)
    assert not (diff & ~near).any(), int((diff & ~near).sum())
    assert diff.sum() <= 0.001 * diff.size, int(diff.sum())


def test_identity_scale_recovers_the_source():
    """Scale 1 and a crop the size of the source: the source itself, up to
    the drawn flips."""
    imgs, masks = make_batch(2, 3, 40, 40)
    gen = torch.Generator().manual_seed(0)
    params = draw_params(gen, 3, 40, 40, 40, 40)
    out_i, out_m = augment_with_params(torch.from_numpy(imgs), torch.from_numpy(masks),
                                       params, np.zeros(3), np.ones(3), 40)
    assert (params["sizes"] == 40).all() and (params["oy"] == 0).all()
    for i in range(3):
        src, m = imgs[i], masks[i]
        if params["vflip"][i]:
            src, m = src[::-1], m[::-1]
        if params["hflip"][i]:
            src, m = src[:, ::-1], m[:, ::-1]
        np.testing.assert_allclose(out_i[i].numpy(), src, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(out_m[i].numpy(), m)


def test_out_of_bounds_takes_the_fill():
    """A scaled source smaller than the crop: the rest of the crop is image 0
    before normalization (so -mean / std after) and mask 0."""
    imgs, masks = make_batch(3, 2, 32, 32)
    params = {"sizes": torch.tensor([16, 24]), "oy": torch.zeros(2),
              "ox": torch.zeros(2), "hflip": torch.tensor([False, False]),
              "vflip": torch.tensor([False, False])}
    out_i, out_m = augment_with_params(torch.from_numpy(imgs + 1.0),
                                       torch.ones(2, 32, 32, dtype=torch.int32),
                                       params, TP_MEAN, TP_STD, 32)
    fill = torch.from_numpy(-TP_MEAN / TP_STD)
    for i, size in enumerate((16, 24)):
        assert (out_m[i, :size - 1, :size - 1] == 1).all()
        assert (out_m[i, size + 1:] == 0).all() and (out_m[i, :, size + 1:] == 0).all()
        torch.testing.assert_close(out_i[i, size + 1:], fill.expand(32 - size - 1, 32, 3),
                                   rtol=0, atol=1e-5)
        # every in-bounds pixel saw a source value >= 1 before normalization
        assert (out_i[i, :size - 1, :size - 1] * torch.from_numpy(TP_STD)
                + torch.from_numpy(TP_MEAN) >= 1.0 - 1e-5).all()


def test_same_generator_same_batch_and_variety():
    imgs, masks = (torch.from_numpy(a) for a in make_batch(4, 4, 64, 64))
    run = lambda seed: augment_batch(torch.Generator().manual_seed(seed), imgs, masks,
                                     TP_MEAN, TP_STD, crop_size=32, min_size=32,
                                     max_size=76)
    a, b, c = run(7), run(7), run(8)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])


def test_draws_follow_the_ranges():
    gen = torch.Generator().manual_seed(1)
    p = draw_params(gen, 512, 96, 48, 48, 115)
    assert p["sizes"].min() == 48 and p["sizes"].max() == 115  # inclusive ends
    room = torch.clamp_min(96 * p["sizes"].float() / 96 - 48, 0)
    assert ((p["oy"] >= 0) & (p["oy"] <= room)).all()
    assert 0.4 < p["hflip"].float().mean() < 0.6 and 0.4 < p["vflip"].float().mean() < 0.6
