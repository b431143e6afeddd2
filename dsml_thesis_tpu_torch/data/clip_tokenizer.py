"""CLIP BPE tokenizer (``clip.tokenize``).

Counterpart of ``dsml_thesis_tpu/data/clip_tokenizer.py``: the OpenAI
``SimpleTokenizer`` over a BPE merge table that the user supplies as a path
(``bpe_simple_vocab_16e6.txt.gz`` of the ``clip`` package, or plain text) or
as a list of ``"a b"`` merges; nothing is downloaded. The pre-tokenizer's
letter and number classes (``\\p{L}``, ``\\p{N}``) are built from
``unicodedata`` for the standard ``re`` module, so the tokenizer needs no
third-party regex package.
"""
from __future__ import annotations

import gzip
import html
import re
import sys
import unicodedata
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode map (GPT-2 / CLIP convention)."""
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
    return dict(zip(bs, (chr(c) for c in cs)))


def _get_pairs(word: Tuple[str, ...]):
    return {(a, b) for a, b in zip(word[:-1], word[1:])}


def _clean(text: str) -> str:
    # ftfy.fix_text is skipped, as in the JAX package: double-unescape and
    # collapse whitespace
    text = html.unescape(html.unescape(text))
    return " ".join(text.strip().split()).lower()


@lru_cache()
def _category_class(major: str) -> str:
    """The body of a ``re`` character class of every code point whose
    Unicode general category starts with ``major`` ("L": letters, "N":
    numbers), as ranges."""
    parts, start = [], None
    for cp in range(sys.maxunicode + 2):
        inside = (cp <= sys.maxunicode
                  and unicodedata.category(chr(cp))[0] == major)
        if inside and start is None:
            start = cp
        elif not inside and start is not None:
            a, b = re.escape(chr(start)), re.escape(chr(cp - 1))
            parts.append(a if start == cp - 1 else f"{a}-{b}")
            start = None
    return "".join(parts)


@lru_cache()
def _pattern() -> "re.Pattern":
    letters, numbers = _category_class("L"), _category_class("N")
    return re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
        rf"[{letters}]+|[{numbers}]|[^\s{letters}{numbers}]+",
        re.IGNORECASE)


class CLIPTokenizer:
    """BPE tokenizer over a CLIP merge table: a path (``.gz`` or text; the
    OpenAI table's rows 1 .. n_merges) or an iterable of merge strings."""

    SOT = "<|startoftext|>"
    EOT = "<|endoftext|>"

    def __init__(self, merges, n_merges: Optional[int] = 48894):
        if isinstance(merges, str):
            opener = gzip.open if merges.endswith(".gz") else open
            with opener(merges, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
            # the exact slice merges[1 : 49152 - 256 - 2 + 1]: no comment
            # filtering (a merge may start with '#'; dropping one would shift
            # every later rank and id)
            if n_merges is not None:
                lines = lines[1:n_merges + 1]
            else:
                lines = [ln for ln in lines[1:] if ln]
            merges = [ln for ln in lines if ln]
        merge_pairs = [tuple(m.split()) for m in merges]

        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab: List[str] = list(self.byte_encoder.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merge_pairs]
        vocab += [self.SOT, self.EOT]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merge_pairs)}
        self.cache = {self.SOT: self.SOT, self.EOT: self.EOT}
        self.pat = _pattern()

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in self.pat.findall(_clean(text)):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        return bytearray(
            self.byte_decoder[c] for c in text if c in self.byte_decoder
        ).decode("utf-8", errors="replace").replace("</w>", " ").strip()

    def tokenize(self, texts, context_length: int = 77,
                 truncate: bool = False) -> np.ndarray:
        """``<sot> tokens <eot>``, zero-padded: int32 [B, context_length].
        A prompt that does not fit raises unless ``truncate``."""
        if isinstance(texts, str):
            texts = [texts]
        sot, eot = self.encoder[self.SOT], self.encoder[self.EOT]
        out = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            ids = [sot] + self.encode(text) + [eot]
            if len(ids) > context_length:
                if not truncate:
                    raise RuntimeError(f"Input {text!r} is too long for "
                                       f"context length {context_length}")
                ids = ids[:context_length]
                ids[-1] = eot
            out[i, :len(ids)] = ids
        return out
