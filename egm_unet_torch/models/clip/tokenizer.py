"""Byte-pair-encoding tokenizer (CLIP's standard BPE), port of
``egm_unet_tpu/models/clip/tokenizer.py``.

The merges vocabulary (``bpe_simple_vocab_16e6.txt.gz``) is data distributed
with upstream CLIP; like the model weights it is loaded from a user-supplied
path (search order: ``$EGM_CLIP_BPE``, ``./weights/bpe_simple_vocab_16e6.txt.gz``,
the package's ``assets/``), or a merge list is passed as ``merges=``.  The
pre-split is Python's (the token regex); the merge loop runs in Python, or,
with ``native=True``, in the C++ loop of ``egm_unet_torch/native/bpe.cpp``
(built at first use; ``native=True`` raises where it cannot be built, it
never drops to Python).  ``SimpleTokenizer.merge_loop`` names the loop.

Long-CLIP contract: default context length 248 = 77 * 4 - 60; truncation
keeps the EOT token.
"""

from __future__ import annotations

import ctypes
import functools
import gzip
import html
import os
from typing import List, Union

import numpy as np

_DEFAULT_PATHS = (
    os.environ.get("EGM_CLIP_BPE", ""),
    os.path.join("weights", "bpe_simple_vocab_16e6.txt.gz"),
    os.path.join(os.path.dirname(__file__), "assets", "bpe_simple_vocab_16e6.txt.gz"),
)

LONG_CONTEXT = 77 * 4 - 60  # 248


@functools.lru_cache()
def bytes_to_unicode():
    """Reversible byte <-> printable-unicode map (standard GPT-2/CLIP BPE)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _basic_clean(text: str) -> str:
    try:
        import ftfy

        text = ftfy.fix_text(text)
    except ImportError:
        pass
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    import re

    return re.sub(r"\s+", " ", text).strip()


def _token_pattern():
    """CLIP's token regex; uses the ``regex`` module if present, else a
    close stdlib-re approximation (unicode letter/number classes)."""
    try:
        import regex

        return regex.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
            regex.IGNORECASE,
        )
    except ImportError:
        import re

        # [^\W\d_] ~= \p{L}; \d ~= \p{N} (digits only — adequate for ascii+)
        return re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|[^\s\w]+""",
            re.IGNORECASE | re.UNICODE,
        )


def find_vocab(path: str | None = None) -> str:
    for p in ([path] if path else []) + [p for p in _DEFAULT_PATHS if p]:
        if p and os.path.isfile(p):
            return p
    raise FileNotFoundError(
        "BPE vocab bpe_simple_vocab_16e6.txt.gz not found; set $EGM_CLIP_BPE "
        "or place it under ./weights/ (it ships with upstream OpenAI CLIP)")


class SimpleTokenizer:
    def __init__(self, bpe_path: str | None = None, merges: list | None = None,
                 native: bool = False):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        if merges is None:
            bpe_path = find_vocab(bpe_path)
            raw = gzip.open(bpe_path).read().decode("utf-8").split("\n")
            merges = raw[1 : 49152 - 256 - 2 + 1]
            merges = [tuple(m.split()) for m in merges]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        self.pat = _token_pattern()
        self._native = _NativeBPE(vocab, merges) if native else None
        self.merge_loop = "native" if native else "python"

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        """Pre-split with CLIP's token regex, then merge each word (in the
        ``merge_loop``)."""
        bpe_tokens: List[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for token in self.pat.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            if self._native is not None:
                bpe_tokens.extend(self._native.encode_word(token, self.encoder))
            else:
                bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        return (bytearray(self.byte_decoder[c] for c in text)
                .decode("utf-8", errors="replace").replace("</w>", " "))


class _NativeBPE:
    """ctypes binding of the C++ merge loop; builds the library or raises."""

    def __init__(self, vocab, merges):
        from egm_unet_torch.native import load_library

        lib = load_library("bpe")
        lib.bpe_create.restype = ctypes.c_void_p
        lib.bpe_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.bpe_encode_word.restype = ctypes.c_int32
        lib.bpe_encode_word.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        lib.bpe_free.restype = None
        lib.bpe_free.argtypes = [ctypes.c_void_p]
        symbols = "\n".join(vocab).encode("utf-8")
        ranks = "\n".join(f"{a} {b}" for a, b in merges).encode("utf-8")
        self._lib = lib
        self._handle = ctypes.c_void_p(lib.bpe_create(symbols, ranks))
        self._cache: dict = {}

    def encode_word(self, token: str, encoder) -> list:
        """The merged ids of one pre-split word (byte-encoded)."""
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        init = [encoder[c] for c in token[:-1]] + [encoder[token[-1] + "</w>"]]
        n = len(init)
        in_arr = (ctypes.c_int32 * n)(*init)
        out_arr = (ctypes.c_int32 * n)()
        m = self._lib.bpe_encode_word(self._handle, in_arr, n, out_arr, n)
        ids = list(out_arr[:m])
        self._cache[token] = ids
        return ids

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle is not None:
            self._lib.bpe_free(handle)


_tokenizer_cache: dict = {}


def tokenize(
    texts: Union[str, List[str]],
    context_length: int = LONG_CONTEXT,
    truncate: bool = False,
    tokenizer: SimpleTokenizer | None = None,
) -> np.ndarray:
    """[N, context_length] int32 tokens, SOT/EOT framed, zero padded."""
    if isinstance(texts, str):
        texts = [texts]
    if tokenizer is None:
        if "default" not in _tokenizer_cache:
            _tokenizer_cache["default"] = SimpleTokenizer()
        tokenizer = _tokenizer_cache["default"]
    sot = tokenizer.encoder["<|startoftext|>"]
    eot = tokenizer.encoder["<|endoftext|>"]
    result = np.zeros((len(texts), context_length), np.int32)
    for i, text in enumerate(texts):
        tokens = [sot] + tokenizer.encode(text) + [eot]
        if len(tokens) > context_length:
            if truncate:
                tokens = tokens[:context_length]
                tokens[-1] = eot
            else:
                raise RuntimeError(
                    f"Input {text} is too long for context length {context_length}")
        result[i, : len(tokens)] = tokens
    return result
