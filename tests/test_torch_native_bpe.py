"""egm_unet_torch's native BPE merge loop: against its own Python loop on
``tests/test_native_bpe.py``'s merges and words and on a seeded word list,
against the JAX package's tokenizer ids, ``native=True`` never falling back
to Python, and two threads building the library into one empty build
directory at once."""

import threading

import numpy as np
import pytest

from egm_unet_tpu.models.clip.tokenizer import SimpleTokenizer as JSimpleTokenizer

from egm_unet_torch import native
from egm_unet_torch.models.clip.tokenizer import SimpleTokenizer, tokenize

from tests.test_native_bpe import MERGES

WORDS = ["hello", "world", "hello world", "abab", "ababab", "a", "zzz", "hell",
         "ello", "llll", "hello, world!", "HeLLo   wOrld", "&amp; ab"]


def seeded_texts(n=200, seed=0):
    rng = np.random.default_rng(seed)
    alphabet = "helowrdab ,.!"
    return ["".join(alphabet[i] for i in rng.integers(0, len(alphabet), int(rng.integers(1, 40))))
            for _ in range(n)]


@pytest.fixture(scope="module")
def toks():
    return (SimpleTokenizer(merges=MERGES, native=True),
            SimpleTokenizer(merges=MERGES, native=False))


def test_merge_loop_named(toks):
    nat, py = toks
    assert nat.merge_loop == "native" and py.merge_loop == "python"
    assert SimpleTokenizer(merges=MERGES).merge_loop == "python"


def test_native_matches_python(toks):
    nat, py = toks
    for text in WORDS + seeded_texts():
        assert nat.encode(text) == py.encode(text), repr(text)


def test_ids_match_jax_tokenizer(toks):
    nat, py = toks
    jnat = JSimpleTokenizer(merges=MERGES, native=True)
    jpy = JSimpleTokenizer(merges=MERGES, native=False)
    texts = WORDS + seeded_texts(seed=1)
    for text in texts:
        ids = jpy.encode(text)
        assert nat.encode(text) == py.encode(text) == jnat.encode(text) == ids, repr(text)
    np.testing.assert_array_equal(tokenize(texts, 64, truncate=True, tokenizer=nat),
                                  tokenize(texts, 64, truncate=True, tokenizer=jpy))
    assert nat.decode(nat.encode("hello world")).strip() == "hello world"


def test_native_raises_without_a_compiler(monkeypatch, tmp_path):
    """``native=True`` builds or raises; it does not drop to Python."""
    monkeypatch.setenv("EGM_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        SimpleTokenizer(merges=MERGES, native=True)


def test_concurrent_build(monkeypatch, tmp_path):
    """Two threads build into one empty build directory at once: each
    compiles to a temporary name of its own and renames it into place, and
    both load a working library."""
    monkeypatch.setenv("EGM_TORCH_BUILD_DIR", str(tmp_path))
    paths, errors = [], []
    barrier = threading.Barrier(2)

    def build():
        try:
            barrier.wait()
            paths.append(native.build_library("bpe"))
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert len(paths) == 2 and paths[0] == paths[1] and paths[0].parent == tmp_path
    assert [p.name for p in tmp_path.iterdir()] == [paths[0].name]  # no temporary left
    monkeypatch.setattr(native, "_LIBS", {})
    tok = SimpleTokenizer(merges=MERGES, native=True)
    assert tok.encode("hello world") == SimpleTokenizer(merges=MERGES).encode("hello world")
