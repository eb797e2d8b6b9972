r"""CLIP byte-pair-encoding tokenizer (host-side, feeds [B, 77] int32 arrays).

Replacement for ``clip.tokenize`` (reference `clip_ppo_utils.py:136-138`):
tokenization is host work that produces fixed-shape integer arrays the text
encoder consumes, so the device never sees strings. The BPE algorithm is the standard byte-level BPE
OpenAI CLIP uses (bytes→unicode mapping, greedy lowest-rank pair merging,
``</w>`` end-of-word marker, 49152-token vocab with 256 byte tokens + 256
``</w>`` byte tokens + 48894 merges + 2 specials).

The merge table (`bpe_simple_vocab_16e6.txt.gz`) ships with OpenAI's
``clip`` package and is not vendorable here; it is loaded from
``$CLIP_PPO_BPE_PATH`` when that file exists. Without it, :class:`HashTokenizer` provides a deterministic
stand-in with the same interface and output shape so every downstream
component (text encoder, alignment loss, training loop) runs unchanged;
embeddings then differ from OpenAI's, which only matters when comparing
against real pretrained CLIP checkpoints (which equally need downloading).

Cleaning differs from OpenAI in one documented way: ``ftfy.fix_text`` is
replaced by ``html.unescape`` (ftfy is not available in this environment);
for the ASCII task descriptions this framework generates the two are
identical. The word-splitting pattern uses the standard library's ``re``
(the ``regex`` package's ``\p{L}``/``\p{N}`` classes become ``[^\W\d_]``
and ``\d``); the two agree on ASCII text, which is all this package feeds
it.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
from typing import Iterable, Sequence

import numpy as np

import re

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408
SOT_TEXT = "<|startoftext|>"
EOT_TEXT = "<|endoftext|>"

_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|(?:[^\s\w]|_)+""",
    re.IGNORECASE,
)



@functools.lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """Reversible byte→printable-unicode map (standard byte-level BPE)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word[:-1], word[1:]))


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text)
    return text.strip()


class BPETokenizer:
    """CLIP's SimpleTokenizer given an explicit merge list.

    ``merges`` is the ordered list of merge pairs (earlier = higher
    priority); the vocabulary is derived from it exactly as OpenAI does:
    256 byte symbols, the same 256 with ``</w>``, one token per merge,
    then the two special tokens.
    """

    def __init__(self, merges: Sequence[tuple[str, str]]):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend([SOT_TEXT, EOT_TEXT])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.cache: dict[str, str] = {SOT_TEXT: SOT_TEXT, EOT_TEXT: EOT_TEXT}
        self.sot_token = self.encoder[SOT_TEXT]
        self.eot_token = self.encoder[EOT_TEXT]
        self.vocab_size = len(vocab)
        self._row_cache: dict[tuple, np.ndarray] = {}

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
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

    def encode(self, text: str) -> list[int]:
        text = _clean(text).lower()
        words = re.findall(_PAT, text)
        bpe_tokens: list[int] = []
        for token in words:
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens: Iterable[int]) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def tokenize(
        self, texts: str | Sequence[str], context_length: int = CONTEXT_LENGTH,
        truncate: bool = True,
    ) -> np.ndarray:
        """Batch of strings → [B, context_length] int32, SOT/EOT framed,
        zero padded — the exact ``clip.tokenize`` output contract."""
        if isinstance(texts, str):
            texts = [texts]
        result = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            # Row memo: training descriptions are highly repetitive
            # (templated per-state strings), so whole rows hit the cache.
            ck = (text, context_length, truncate)
            row = self._row_cache.get(ck)
            if row is not None:
                result[i] = row
                continue
            tokens = [self.sot_token] + self.encode(text) + [self.eot_token]
            if len(tokens) > context_length:
                if not truncate:
                    raise RuntimeError(
                        f"input {text!r} is too long for context length "
                        f"{context_length}"
                    )
                tokens = tokens[:context_length]
                tokens[-1] = self.eot_token
            result[i, : len(tokens)] = tokens
            if len(self._row_cache) < 200_000:
                self._row_cache[ck] = result[i].copy()
        return result


def load_merges(path: str) -> list[tuple[str, str]]:
    """Read OpenAI's gzip'd merge file (first line is a version header;
    merges occupy lines 1..48894+1)."""
    with gzip.open(path, "rt", encoding="utf-8") as f:
        lines = f.read().split("\n")
    merges = [tuple(m.split()) for m in lines[1 : 49152 - 256 - 2 + 1]]
    return [m for m in merges if len(m) == 2]


class HashTokenizer:
    """Deterministic vocab-free stand-in with the ``tokenize`` contract.

    Words map to stable FNV-1a hash buckets over the non-special id range;
    identical text → identical ids across processes (no PYTHONHASHSEED
    dependence). Sufficient for training-from-scratch text alignment and
    for exercising the full text pipeline without OpenAI's merge table.
    """

    vocab_size = VOCAB_SIZE
    sot_token = VOCAB_SIZE - 2
    eot_token = VOCAB_SIZE - 1

    @staticmethod
    def _fnv1a(data: bytes) -> int:
        h = 0xCBF29CE484222325
        for b in data:
            h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
        return h

    def encode(self, text: str) -> list[int]:
        text = _clean(text).lower()
        span = self.sot_token  # ids [0, span) are hash buckets
        return [
            self._fnv1a(tok.encode("utf-8")) % span
            for tok in re.findall(_PAT, text)
        ]

    def tokenize(
        self, texts: str | Sequence[str], context_length: int = CONTEXT_LENGTH,
        truncate: bool = True,
    ) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        result = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            tokens = [self.sot_token] + self.encode(text) + [self.eot_token]
            if len(tokens) > context_length:
                if not truncate:
                    raise RuntimeError(
                        f"input {text!r} is too long for context length "
                        f"{context_length}"
                    )
                tokens = tokens[:context_length]
                tokens[-1] = self.eot_token
            result[i, : len(tokens)] = tokens
        return result


def find_bpe_vocab() -> str | None:
    """``$CLIP_PPO_BPE_PATH``, then
    ``~/.cache/clip_ppo_tpu/bpe_simple_vocab_16e6.txt.gz``: the first that
    exists, else None."""
    for p in (os.environ.get("CLIP_PPO_BPE_PATH", ""),
              os.path.expanduser("~/.cache/clip_ppo_tpu/bpe_simple_vocab_16e6.txt.gz")):
        if p and os.path.exists(p):
            return p
    return None


@functools.lru_cache()
def get_tokenizer(bpe_path: str | None = None):
    """The process-wide tokenizer: real BPE when the merge table exists,
    the hash stand-in otherwise (see module docstring)."""
    path = bpe_path or find_bpe_vocab()
    if path is not None:
        return BPETokenizer(load_merges(path))
    return HashTokenizer()


def tokenize(
    texts: str | Sequence[str], context_length: int = CONTEXT_LENGTH,
    truncate: bool = True,
) -> np.ndarray:
    """Module-level convenience mirroring ``clip.tokenize``."""
    return get_tokenizer().tokenize(texts, context_length, truncate)
