"""egm_unet_torch CLIP (ViT with CSA, Long-CLIP text tower, tokenizer, vanilla
CSA api) against egm_unet_tpu on the CPU in float32, on the TINY config of
``tests/test_clipseg.py``.  Weights come from seeded numpy through the flax
bridge.

Tolerance 1e-3 on every model output: a few blocks of float32 matmuls and
softmaxes summed in another order than XLA."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egm_unet_tpu.models.clip import csa_api as jcsa_api
from egm_unet_tpu.models.clip import model as jmodel
from egm_unet_tpu.models.clip import tokenizer as jtok

from egm_unet_torch.models.clip import csa_api, tokenizer
from egm_unet_torch.models.clip.model import (CLIP, KEEP_LEN, VIT_B16, VIT_B32,
                                              CLIPConfig, get_attn,
                                              stretch_positional_embedding)
from egm_unet_torch.models.registry import init_weights
from egm_unet_torch.nn.layers import cast_weights
from egm_unet_torch.ops.cuda import launch_counts, reset_launch_counts
from egm_unet_torch.utils import load_flax_variables

from tests.torch_port_util import assert_close, random_variables, to_torch



@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


KW = dict(embed_dim=32, image_resolution=32, vision_layers=3, vision_width=64,
          vision_patch_size=16, context_length=24, vocab_size=512,
          transformer_width=64, transformer_heads=2, transformer_layers=3,
          long_clip=True)
TINY = CLIPConfig(**KW)
JTINY = jmodel.CLIPConfig(**KW)
TOL = dict(rtol=1e-3, atol=1e-3)


def _inputs(size=32, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((batch, size, size, 3)).astype(np.float32)
    tok = np.zeros((batch, KW["context_length"]), np.int32)
    for i in range(batch):
        n = 3 + 9 * i  # a short and a longer prompt; EOT = the highest id
        tok[i, :n] = rng.integers(1, 500, n)
        tok[i, 0], tok[i, n - 1] = 510, 511
    return img, tok


@pytest.fixture(scope="module")
def pair():
    img, tok = _inputs()
    jm = jmodel.CLIP(JTINY, attn_impl="xla")
    v = random_variables(jm, jnp.asarray(img), jnp.asarray(tok), seed=7)
    port = load_flax_variables(CLIP(TINY), v).eval()
    return jm, v, port


def _japply(jm, v, method, *args, **kw):
    return jax.jit(lambda vv, *a: jm.apply(vv, *a, method=method, **kw))(v, *args)


@pytest.mark.parametrize("csa_on", [True, False])
def test_encode_image(pair, csa_on):
    jm, v, port = pair
    img, _ = _inputs(seed=1)
    ref = _japply(jm, v, jm.encode_image, jnp.asarray(img), csa=csa_on)
    assert_close(port.encode_image(to_torch(img), csa=csa_on), ref, **TOL)
    ref_all = _japply(jm, v, jm.encode_image, jnp.asarray(img), return_all=True)
    assert_close(port.encode_image(to_torch(img), return_all=True), ref_all, **TOL)


@pytest.mark.parametrize("size", [32, 64])  # native, and a resampled 4x4 grid
def test_dense_forward_with_extraction(pair, size):
    jm, v, port = pair
    img, _ = _inputs(size=size, seed=2)
    ref_p, ref_a = _japply(jm, v, jm.visual_forward_dense, jnp.asarray(img),
                           extract_layers=(0, 2))
    pooled, acts = port.visual_forward_dense(to_torch(img), extract_layers=(0, 2))
    assert_close(pooled, ref_p, **TOL)
    assert len(acts) == 2
    for a, r in zip(acts, ref_a):
        assert a.shape == (2, (size // 16) ** 2 + 1, 64)
        assert_close(a, r, **TOL)


def test_dense_early_stop_equals_full_pass(pair):
    _, _, port = pair
    img, _ = _inputs(seed=3)
    full_p, full = port.visual_forward_dense(to_torch(img), extract_layers=(0, 1))
    none_p, early = port.visual_forward_dense(to_torch(img), extract_layers=(0, 1),
                                              pooled=False)
    assert none_p is None and full_p is not None
    for a, b in zip(early, full):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("mask_type", ["cls_token", "all"])
def test_visual_prompt_mask(pair, mask_type):
    jm, v, port = pair
    img, _ = _inputs(size=64, seed=4)
    seg = (np.random.default_rng(5).uniform(0, 1, (2, 64, 64)) > 0.5).astype(np.float32)
    ref = jax.jit(lambda vv, x, s: jm.apply(
        vv, x, csa=True, dense=True, mask=(mask_type, s),
        method=lambda m, *a, **k: m.visual(*a, **k)))(v, jnp.asarray(img), jnp.asarray(seg))
    out = port.visual(to_torch(img), csa=True, dense=True,
                      mask=(mask_type, to_torch(seg)))
    assert_close(out, ref, **TOL)


def test_encode_text_longclip(pair):
    jm, v, port = pair
    _, tok = _inputs(seed=6)
    ref = _japply(jm, v, jm.encode_text, jnp.asarray(tok))
    assert_close(port.encode_text(torch.from_numpy(tok)), ref, **TOL)
    ref_full = _japply(jm, v, jm.encode_text, jnp.asarray(tok), pool=False)
    assert_close(port.encode_text(torch.from_numpy(tok), pool=False), ref_full, **TOL)
    # the positions are the first KEEP_LEN rows of one table and the rest of
    # the other
    pos = port._text_pos()
    torch.testing.assert_close(pos[:KEEP_LEN], port.positional_embedding[:KEEP_LEN])
    torch.testing.assert_close(pos[KEEP_LEN:], port.positional_embedding_res[KEEP_LEN:])


def test_contrastive_logits(pair):
    jm, v, port = pair
    img, tok = _inputs(seed=8)
    ref_i, ref_t = jax.jit(jm.apply)(v, jnp.asarray(img), jnp.asarray(tok))
    out_i, out_t = port(to_torch(img), torch.from_numpy(tok))
    assert_close(out_i, ref_i, **TOL)
    assert_close(out_t, ref_t, **TOL)


def test_get_attn(pair):
    jm, v, port = pair
    img, _ = _inputs(seed=9)
    ref = jmodel.get_attn(jm, v, jnp.asarray(img), "final")
    assert_close(get_attn(port, to_torch(img), "final"), ref, **TOL)
    ref_all = jmodel.get_attn(jm, v, jnp.asarray(img), "all", csa=False)
    got_all = get_attn(port, to_torch(img), "all", csa=False)
    assert len(got_all) == len(ref_all) == 3
    for g, r in zip(got_all, ref_all):
        assert_close(g, r, **TOL)
    with pytest.raises(ValueError):
        get_attn(port, to_torch(img), "middle")


def test_csa_runs_through_the_kernel_wrapper(pair, monkeypatch):
    """Dense path: CSA in every block; encode path: in the last block only;
    a mask or returned weights bypass the wrapper."""
    from egm_unet_torch.models.clip import model as pmodel

    _, _, port = pair
    calls = []
    real = pmodel.csa_attention
    monkeypatch.setattr(pmodel, "csa_attention",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    img = to_torch(_inputs(seed=10)[0])
    port.visual_forward_dense(img, extract_layers=(0, 1))
    assert len(calls) == 3
    port.visual_forward_dense(img, extract_layers=(0, 1), pooled=False)
    assert len(calls) == 5
    port.encode_image(img)
    assert len(calls) == 6
    port.encode_image(img, csa=False)
    port.encode_text(torch.from_numpy(_inputs()[1]))
    port.visual(img, dense=True, mask=("all", torch.ones(2, 32, 32)))
    get_attn(port, img, "final")
    assert len(calls) == 6
    reset_launch_counts()
    port.encode_image(img)
    assert launch_counts()["csa_attention"] == 0  # CPU: no kernel launch


def test_block_hands_in_proj_views_to_csa(pair, monkeypatch):
    """The block passes the three ``chunk`` views of ``in_proj``'s output to
    ``csa_attention`` as they are (no contiguous copies), and its output still
    matches the flax block."""
    from egm_unet_torch.models.clip import model as pmodel

    jm, v, port = pair
    block = port.visual.resblock0
    seen = []
    real = pmodel.csa_attention

    def spy(q, k, v_, heads):
        seen.append((q, k, v_))
        return real(q, k, v_, heads)

    monkeypatch.setattr(pmodel, "csa_attention", spy)
    x = np.random.default_rng(12).standard_normal((2, 5, 64)).astype(np.float32)
    out = block(to_torch(x), csa=True)
    (q, k, v_), = seen
    width, item = 64, q.element_size()
    assert q.shape == k.shape == v_.shape == (2, 5, width)
    assert not q.is_contiguous() and q.stride() == k.stride() == v_.stride() \
        == (5 * 3 * width, 3 * width, 1)
    store = q.untyped_storage().data_ptr()
    assert k.untyped_storage().data_ptr() == v_.untyped_storage().data_ptr() == store
    assert (k.data_ptr() - q.data_ptr(), v_.data_ptr() - q.data_ptr()) \
        == (width * item, 2 * width * item)
    jblock = jmodel.ResidualAttentionBlock(width, block.heads, attn_impl="xla")
    ref = jax.jit(lambda p, a: jblock.apply({"params": p}, a, csa=True))(
        v["params"]["visual"]["resblock0"], jnp.asarray(x))
    assert_close(out, ref, **TOL)


def test_bf16_cast_leaves_float32_parameters_alone(pair):
    _, _, ref = pair
    img, tok = _inputs(seed=11)
    port = CLIP(TINY)
    port.load_state_dict(ref.state_dict())
    cast_weights(port, torch.bfloat16)
    for name, p in port.named_parameters():
        leaf = name.rsplit(".", 2)
        is_matmul = name.endswith((".kernel", ".bias")) and not any(
            ln in name for ln in ("ln_", ".ln", "ln_final"))
        assert p.dtype == (torch.bfloat16 if is_matmul else torch.float32), (name, leaf)
    assert port.dtype == torch.bfloat16
    out = port.encode_image(to_torch(img))
    txt = port.encode_text(torch.from_numpy(tok))
    assert out.dtype == torch.bfloat16 and txt.dtype == torch.bfloat16
    want = ref.encode_image(to_torch(img))
    assert_close(out, want.numpy(), 1e-1, 1e-1)  # three blocks of bf16 matmuls
    # a blanket .to(bfloat16) rounds the LayerNorm parameters too: refused
    blanket = CLIP(TINY).to(torch.bfloat16)
    with pytest.raises(TypeError, match="cast_weights"):
        blanket.encode_image(to_torch(img))


def test_resnet_tower_not_ported():
    """The RN tower is ported now (its parity: tests/test_torch_clip_resnet.py):
    a tuple ``vision_layers`` builds it, and the dense CLIPSeg path refuses
    it as the JAX package does."""
    model = CLIP(dataclasses.replace(TINY, vision_layers=(1, 1, 1, 1), image_resolution=64))
    assert type(model.visual).__name__ == "ModifiedResNet"
    img = torch.zeros(1, 64, 64, 3)
    assert model.encode_image(img).shape == (1, KW["embed_dim"])
    with pytest.raises(ValueError, match="ViT"):
        model.visual_forward_dense(img, [1])


def test_configs_and_stretch():
    for name in ("VIT_B16", "VIT_B32"):
        # every field of the JAX config; the port's one more, ``recompute``,
        # is off in these presets
        port = dataclasses.asdict({"VIT_B16": VIT_B16, "VIT_B32": VIT_B32}[name])
        assert port.pop("recompute") is False
        assert dataclasses.asdict(getattr(jmodel, name)) == port
    assert VIT_B16.vision_heads == 12 and KEEP_LEN == jmodel.KEEP_LEN
    for name in ("VANILLA_CSA_B16", "VANILLA_CSA_B32"):
        port = dataclasses.asdict(getattr(csa_api, name))
        assert port.pop("recompute") is False
        assert dataclasses.asdict(getattr(jcsa_api, name)) == port
    pe = np.random.default_rng(0).standard_normal((77, 8)).astype(np.float32)
    out = stretch_positional_embedding(pe)
    assert out.shape == (248, 8)
    np.testing.assert_array_equal(out, jmodel.stretch_positional_embedding(pe))


MERGES = [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o</w>"), ("w", "o"),
          ("r", "l"), ("d", "</w>"), ("wo", "rl"), ("e", "l"), ("el", "l"),
          ("a", "b"), ("ab", "ab")]
TEXTS = ["hello", "hello world", "abab ababab", "Hello,   WORLD!", "a photo of a hell",
         "zzz &amp; llll", "it's 42 o'clock"]


def test_tokenizer_ids_equal():
    jt = jtok.SimpleTokenizer(merges=MERGES, native=False)
    pt = tokenizer.SimpleTokenizer(merges=MERGES)
    for text in TEXTS:
        assert pt.encode(text) == jt.encode(text), text
        assert pt.decode(pt.encode(text)) == jt.decode(jt.encode(text))
    np.testing.assert_array_equal(tokenizer.tokenize(TEXTS, tokenizer=pt),
                                  jtok.tokenize(TEXTS, tokenizer=jt))
    assert tokenizer.tokenize(TEXTS, tokenizer=pt).shape == (len(TEXTS), 248)
    long = " ".join(["hello world"] * 60)
    np.testing.assert_array_equal(
        tokenizer.tokenize(long, context_length=16, truncate=True, tokenizer=pt),
        jtok.tokenize(long, context_length=16, truncate=True, tokenizer=jt))
    with pytest.raises(RuntimeError, match="too long"):
        tokenizer.tokenize(long, context_length=16, tokenizer=pt)
    np.testing.assert_array_equal(csa_api.tokenize77(TEXTS, tokenizer=pt),
                                  jcsa_api.tokenize77(TEXTS, tokenizer=jt))


def test_find_vocab_and_native_loop_absent(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tokenizer, "_DEFAULT_PATHS", ())
    with pytest.raises(FileNotFoundError, match="bpe_simple_vocab"):
        tokenizer.find_vocab()
    f = tmp_path / "vocab.txt.gz"
    f.write_bytes(b"")
    assert tokenizer.find_vocab(str(f)) == str(f)
    # the native merge loop is opt-in (native=True); by default it is absent
    tok = tokenizer.SimpleTokenizer(merges=[("a", "b")])
    assert tok.merge_loop == "python" and tok._native is None


def test_build_vanilla_csa_random():
    cfg = dataclasses.replace(TINY, context_length=77, long_clip=False)
    model = csa_api.build_vanilla_csa(generator=torch.Generator().manual_seed(0),
                                      cfg=cfg)
    assert model.cfg.context_length == 77 and not model.cfg.long_clip
    assert not hasattr(model, "positional_embedding_res")
    again = init_weights(CLIP(cfg), torch.Generator().manual_seed(0))
    torch.testing.assert_close(model.visual.proj, again.visual.proj, rtol=0, atol=0)
    assert float(model.visual.proj.abs().max()) > 0
