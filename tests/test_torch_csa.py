"""egm_unet_torch attention against egm_unet_tpu on the CPU: the plain version
of kernel K6 against the Pallas kernel in interpret mode and against the
einsum path, the gradient through the autograd.Function against jax.grad, and
the options of ``multi_head_attention``.

Tolerances: float32 2e-4 (softmax sums in another order), bf16 5e-2, the bars
``tests/test_pallas.py`` sets for the same comparison.  Strided views against
the contiguous call: 1e-5 in float32 (the same arithmetic on the same values).
The tensor-core kernel's rounding profile, emulated on the CPU, is held to the
bf16 tolerance of the GPU smoke run: one bf16 step of the output's magnitude,
``2**-7 * max|out|``."""

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


@pytest.mark.parametrize("bad", ["heads", "hd", "dtype", "strided", "mixed", "shape",
                                 "rank"])
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
        q = torch.cat([q, q], dim=-1)[..., ::2]  # last stride 2
    elif bad == "mixed":
        k = k.bfloat16()
    elif bad == "shape":
        k = k[:, :5].contiguous()
    elif bad == "rank":
        q, k, v = q[0], k[0], v[0]
    with pytest.raises((ValueError, TypeError)):
        csa.csa_attention(q, k, v, h)


def _views(q, k, v):
    """q, k, v as the three ``chunk`` views of one [B, S, 3 D] tensor."""
    return torch.cat([q, k, v], dim=-1).chunk(3, dim=-1)


@pytest.mark.parametrize("b,s,d,h", SHAPES + [(3, 33, 27, 3)])
def test_csa_attention_takes_strided_views(b, s, d, h):
    q, k, v = map(to_torch, _qkv(b, s, d, seed=7))
    vq, vk, vv = _views(q, k, v)
    assert not vq.is_contiguous() and vq.stride() == (s * 3 * d, 3 * d, 1)
    out = csa.csa_attention(vq, vk, vv, h)
    assert out.is_contiguous() and out.shape == (b, s, d)
    assert_close(out, csa.csa_attention(q, k, v, h), 1e-5, 1e-5)
    ref = jcsa(*(jnp.asarray(t.numpy()) for t in (q, k, v)), h, interpret=True)
    assert_close(out, ref, 2e-4, 2e-4)
    # a row-strided view (every other token) is a view with last stride 1 too
    out2 = csa.csa_attention(vq[:, ::2], vk[:, ::2], vv[:, ::2], h)
    assert_close(out2, csa.csa_attention(q[:, ::2].contiguous(), k[:, ::2].contiguous(),
                                         v[:, ::2].contiguous(), h), 1e-5, 1e-5)


def test_csa_gradients_flow_through_views():
    """The backward on the ``chunk`` views of one in_proj output gives the
    gradient it gives on three contiguous tensors (its accuracy against
    ``csa_plain`` and JAX is held below)."""
    q, k, v = map(to_torch, _qkv(2, 9, 32, seed=8))
    with torch.enable_grad():
        qkv = torch.cat([q, k, v], dim=-1).requires_grad_(True)
        csa.csa_attention(*qkv.chunk(3, dim=-1), 4).square().sum().backward()
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        csa.csa_attention(*leaves, 4).square().sum().backward()
    assert_close(qkv.grad, torch.cat([t.grad for t in leaves], dim=-1), 1e-5, 1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_csa_variant(dtype):
    want = {torch.float32: "ffma_f32", torch.bfloat16: "mma_bf16"}[dtype]
    assert csa.csa_variant(dtype) == want
    with pytest.raises(TypeError):
        csa.csa_variant(torch.float16)


def csa_mma_emulation(q, k, v, num_heads, key_tile=64):
    """The rounding profile of the tensor-core kernel, in plain PyTorch on
    bfloat16 inputs: per head, float32 scores from the unscaled bf16 operands,
    an online softmax over tiles of ``key_tile`` keys per state (running
    maximum of the raw scores, weights ``exp2(s*c - m*c)``), the weights
    rounded to bf16 before they meet v with float32 sums, the row sums taken
    from the float32 weights, and ``O1 / l1 + O2 / l2`` rounded once."""
    b, s, d = q.shape
    hd = d // num_heads
    c = np.float32(1.4426950408889634 / np.sqrt(hd))
    heads = lambda t: t.reshape(b, s, num_heads, hd).permute(0, 2, 1, 3).float()
    qh, kh, vh = heads(q), heads(k), heads(v)
    out = torch.zeros_like(qh)
    for a in (qh, kh):
        m = torch.full((b, num_heads, s, 1), -np.inf)
        l = torch.zeros((b, num_heads, s, 1))
        o = torch.zeros_like(qh)
        for k0 in range(0, s, key_tile):
            sc = a @ a[:, :, k0:k0 + key_tile].transpose(-1, -2)  # exact bf16 products
            mn = torch.maximum(m, sc.amax(-1, keepdim=True))
            corr = torch.exp2((m - mn) * c)
            p = torch.exp2(sc * c - mn * c)
            l = l * corr + p.sum(-1, keepdim=True)
            o = o * corr + p.bfloat16().float() @ vh[:, :, k0:k0 + key_tile]
            m = mn
        out = out + o / l
    return out.permute(0, 2, 1, 3).reshape(b, s, d).to(q.dtype)


# a shape like the path's and the odd shapes of the GPU smoke run
EMULATION_SHAPES = [(2, 485, 128, 2), (2, 10, 32, 4), (1, 64, 64, 1), (1, 17, 64, 2),
                    (3, 197, 768, 12), (2, 70, 200, 2), (2, 100, 128, 2), (3, 33, 27, 3),
                    (2, 5, 64, 1), (1, 64, 128, 2), (1, 65, 128, 2)]


@pytest.mark.parametrize("b,s,d,h", EMULATION_SHAPES)
def test_mma_rounding_profile_within_gpu_tolerance(b, s, d, h):
    gen = torch.Generator().manual_seed(1)
    q, k, v = [(torch.randn(b, s, d, generator=gen) * sc).bfloat16()
               for sc in (1.5, 1.0, 1.0)]  # the smoke run's operand scales
    ref = csa.csa_plain(q, k, v, h).float()
    got = csa_mma_emulation(q, k, v, h, key_tile=64 if d // h <= 64 else 32).float()
    tol = 2.0 ** -7 * max(ref.abs().max().item(), 1e-3)
    assert (got - ref).abs().max().item() <= tol


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


# ------------------------------------------------- the closed-form backward
# ``csa_backward`` against jax.vjp of the JAX kernel (Pallas in interpret mode
# forward, the einsum path's VJP backward), against autograd through
# ``csa_plain``, and against the float64 gradient of the formula (autograd
# through a float64 einsum written here), on chunk views of one in_proj output
# and on contiguous tensors.  Both references compute scores and softmaxes in
# float32, and a softmax near one-hot gives gradients small beside the terms
# they are made from, so a float32 gradient carries an error of its own: each
# comparison with a float32 reference allows 2e-4 of the largest gradient plus
# twice that reference's own distance from the float64 value.  The closed
# form in float64 holds the float64 value within 1e-10 of the largest
# gradient; bf16 holds autograd's bf16 gradient within one bf16 step of the
# largest (the card's rule, ``chip_smoke.py::compare``).

BACKWARD_SHAPES = [(2, 12, 32, 4), (1, 33, 64, 1), (2, 50, 128, 2)]


def _grad_case(b, s, d, seed, dtype, views):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, d)) * sc for sc in (1.5, 1.0, 1.0))
    g = rng.standard_normal((b, s, d))
    tq, tk, tv, tg = (torch.from_numpy(a).to(dtype) for a in (q, k, v, g))
    if views:
        tq, tk, tv = _views(tq, tk, tv)
    return (q, k, v, g), (tq, tk, tv, tg)


def _exact(q, k, v, g, h):
    """The float64 gradient of the formula, by autograd."""
    b, s, d = q.shape
    leaves = [torch.from_numpy(np.asarray(t, np.float64)).requires_grad_(True)
              for t in (q, k, v)]
    heads = lambda t: t.reshape(b, s, h, d // h).permute(0, 2, 1, 3)
    with torch.enable_grad():
        qh, kh, vh = map(heads, leaves)
        sm = lambda a: torch.softmax(a @ a.transpose(-1, -2) * (d // h) ** -0.5, dim=-1)
        out = ((sm(qh) + sm(kh)) @ vh).permute(0, 2, 1, 3).reshape(b, s, d)
        grads = torch.autograd.grad(out, leaves, torch.from_numpy(np.asarray(g, np.float64)))
    return [t.numpy() for t in grads]


def _assert_near(got, ref, exact):
    for a, r, e in zip(got, ref, exact):
        a, r = a.double().numpy(), np.asarray(r, np.float64)
        tol = 2e-4 * np.abs(r).max() + 2 * np.abs(r - e).max()
        np.testing.assert_allclose(a, r, rtol=0, atol=tol)


@pytest.mark.parametrize("views", [True, False], ids=["views", "contiguous"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("b,s,d,h", BACKWARD_SHAPES)
def test_csa_backward_matches_jax_vjp(b, s, d, h, dtype, views):
    (q, k, v, g), (tq, tk, tv, tg) = _grad_case(b, s, d, 11, dtype, views)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    with jax.enable_x64(dtype == torch.float64):
        _, vjp = jax.vjp(lambda a, b_, c: jcsa(a, b_, c, h, interpret=True),
                         *(jnp.asarray(t, jdt) for t in (q, k, v)))
        ref = [np.asarray(t) for t in vjp(jnp.asarray(g, jdt))]
    got = csa.csa_backward(tq, tk, tv, tg, h)
    assert all(t.dtype == dtype and t.shape == (b, s, d) for t in got)
    _assert_near(got, ref, _exact(*(t.numpy() for t in (tq, tk, tv, tg)), h))


@pytest.mark.parametrize("views", [True, False], ids=["views", "contiguous"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16],
                         ids=["f32", "f64", "bf16"])
@pytest.mark.parametrize("b,s,d,h", BACKWARD_SHAPES)
def test_csa_backward_matches_autograd_of_plain(b, s, d, h, dtype, views):
    _, (tq, tk, tv, tg) = _grad_case(b, s, d, 12, dtype, views)
    leaves = [t.detach().clone().requires_grad_(True) for t in (tq, tk, tv)]
    with torch.enable_grad():
        want = torch.autograd.grad(csa.csa_plain(*leaves, h), leaves, tg)
    got = csa.csa_backward(tq, tk, tv, tg, h)
    assert all(t.dtype == dtype for t in got)
    if dtype == torch.bfloat16:
        for a, w in zip(got, want):
            tol = 2.0 ** -7 * w.float().abs().max().item()
            assert (a.float() - w.float()).abs().max().item() <= tol
        return
    exact = _exact(*(t.double().numpy() for t in (tq, tk, tv, tg)), h)
    _assert_near(got, [w.double().numpy() for w in want], exact)


@pytest.mark.parametrize("b,s,d,h", BACKWARD_SHAPES)
def test_csa_backward_float64_is_the_exact_gradient(b, s, d, h):
    (q, k, v, g), (tq, tk, tv, tg) = _grad_case(b, s, d, 14, torch.float64, True)
    for a, e in zip(csa.csa_backward(tq, tk, tv, tg, h), _exact(q, k, v, g, h)):
        np.testing.assert_allclose(a.numpy(), e, rtol=0, atol=1e-10 * np.abs(e).max())


def test_csa_backward_calls_neither_plain_nor_mha(monkeypatch):
    """Inside autograd the wrapper's backward is the closed form: with the
    plain version and the einsum path made to raise after the forward, the
    backward still runs and gives ``csa_backward``'s gradient."""
    _, (tq, tk, tv, tg) = _grad_case(2, 9, 32, 13, torch.float32, False)
    want = csa.csa_backward(tq, tk, tv, tg, 4)
    with torch.enable_grad():
        leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
        out = csa.csa_attention(*leaves, 4)
        assert "CSAFunction" in type(out.grad_fn).__name__

        def boom(*a, **k):
            raise AssertionError("the backward called the plain path")
        monkeypatch.setattr(csa, "csa_plain", boom)
        monkeypatch.setattr(csa, "multi_head_attention", boom)
        got = torch.autograd.grad(out, leaves, tg)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
