"""egm_unet_torch attention against egm_unet_tpu on the CPU: the plain version
of kernel K6 against the Pallas kernel in interpret mode and against the
einsum path, the gradient through the autograd.Function against jax.grad, and
the options of ``multi_head_attention``.

Tolerances: float32 2e-4 (softmax sums in another order), bf16 5e-2, the bars
``tests/test_pallas.py`` sets for the same comparison."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egm_unet_tpu.ops.attention import multi_head_attention as jmha
from egm_unet_tpu.ops.pallas.csa import csa_attention as jcsa

from egm_unet_torch.ops.attention import multi_head_attention
from egm_unet_torch.ops.cuda import csa, launch_counts, reset_launch_counts

from tests.torch_port_util import assert_close, to_torch

SHAPES = [(2, 10, 32, 4), (1, 64, 64, 1), (1, 485, 128, 2)]


def _qkv(b, s, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("b,s,d,h", SHAPES)
def test_csa_plain_matches_pallas_interpret(b, s, d, h):
    q, k, v = _qkv(b, s, d)
    ref = jcsa(*map(jnp.asarray, (q, k, v)), h, interpret=True)
    out = csa.csa_plain(*map(to_torch, (q, k, v)), h)
    assert_close(out, ref, 2e-4, 2e-4)


@pytest.mark.parametrize("b,s,d,h", SHAPES)
def test_csa_attention_matches_einsum_path(b, s, d, h):
    q, k, v = _qkv(b, s, d, seed=1)
    ref = jax.jit(lambda a, b_, c: jmha(a, b_, c, h, csa=True))(
        *map(jnp.asarray, (q, k, v)))
    reset_launch_counts()
    out = csa.csa_attention(*map(to_torch, (q, k, v)), h)
    assert launch_counts()["csa_attention"] == 0  # CPU tensors: the plain version
    assert_close(out, ref, 2e-4, 2e-4)
    assert_close(multi_head_attention(*map(to_torch, (q, k, v)), h, csa=True),
                 ref, 2e-4, 2e-4)


def test_csa_bf16():
    q, k, v = _qkv(2, 40, 64, seed=2)
    jq, jk, jv = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))
    ref = jcsa(jq, jk, jv, 2, interpret=True)
    out = csa.csa_attention(*(to_torch(t).bfloat16() for t in (q, k, v)), 2)
    assert out.dtype == torch.bfloat16
    assert_close(out, np.asarray(ref.astype(jnp.float32)), 5e-2, 5e-2)


def test_csa_gradients_match_jax():
    b, s, d, h = 2, 12, 32, 4
    q, k, v = _qkv(b, s, d, seed=3)

    def loss(q_, k_, v_):
        return jnp.sum(jnp.sin(jcsa(q_, k_, v_, h, interpret=True)))

    ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (to_torch(t).requires_grad_(True) for t in (q, k, v))
    with torch.enable_grad():  # other test modules switch grad off globally
        out = csa.csa_attention(tq, tk, tv, h)
        assert out.grad_fn is not None and "CSAFunction" in type(out.grad_fn).__name__
        torch.sin(out).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
        assert_close(got, want, 2e-4, 2e-4)


@pytest.mark.parametrize("bad", ["heads", "hd", "dtype", "strided", "shape", "rank"])
def test_csa_wrapper_rejects(bad):
    q, k, v = (to_torch(t) for t in _qkv(1, 6, 32))
    h = 4
    if bad == "heads":
        h = 5
    elif bad == "hd":
        q, k, v = (to_torch(t) for t in _qkv(1, 4, 256))
        h = 1
    elif bad == "dtype":
        q = q.half()
    elif bad == "strided":
        q = torch.cat([q, q], dim=-1)[..., :32]  # a column slice, row stride 64
    elif bad == "shape":
        k = k[:, :5].contiguous()
    elif bad == "rank":
        q, k, v = q[0], k[0], v[0]
    with pytest.raises((ValueError, TypeError)):
        csa.csa_attention(q, k, v, h)


def test_attention_bias_and_weights():
    b, s, d, h = 2, 9, 32, 4
    q, k, v = _qkv(b, s, d, seed=4)
    bias = np.triu(np.full((s, s), -np.inf, np.float32), k=1)
    ref, ref_w = jmha(*map(jnp.asarray, (q, k, v)), h, attn_bias=jnp.asarray(bias),
                      return_weights=True)
    out, w = multi_head_attention(*map(to_torch, (q, k, v)), h,
                                  attn_bias=to_torch(bias), return_weights=True)
    assert_close(out, ref, 2e-4, 2e-4)
    assert_close(w, ref_w, 2e-4, 2e-4)


@pytest.mark.parametrize("csa_on", [False, True])
@pytest.mark.parametrize("mask_type", ["cls_token", "all"])
def test_mult_mask(mask_type, csa_on):
    b, s, d, h = 2, 10, 32, 2
    q, k, v = _qkv(b, s, d, seed=5)
    mask = np.random.default_rng(6).uniform(0, 1, (b, s - 1)).astype(np.float32)
    ref, ref_w = jmha(*map(jnp.asarray, (q, k, v)), h, csa=csa_on,
                      mult_mask=(mask_type, jnp.asarray(mask)), return_weights=True)
    out, w = multi_head_attention(*map(to_torch, (q, k, v)), h, csa=csa_on,
                                  mult_mask=(mask_type, to_torch(mask)),
                                  return_weights=True)
    assert_close(out, ref, 2e-4, 2e-4)
    assert_close(w, ref_w, 2e-4, 2e-4)
    with pytest.raises(ValueError):
        multi_head_attention(*map(to_torch, (q, k, v)), h,
                             mult_mask=("rows", to_torch(mask)))
