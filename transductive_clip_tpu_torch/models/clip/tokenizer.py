"""CLIP's byte-pair-encoding tokenizer (the port's own copy of
transductive_clip_tpu/models/clip/tokenizer.py).

Loads the standard ``bpe_simple_vocab_16e6.txt.gz`` merges file (the one
shipped with the OpenAI clip package) from ``$CLIP_BPE_PATH`` or
``data/clip_weights/bpe_simple_vocab_16e6.txt.gz``. The BPE algorithm is the
standard byte-level BPE used by GPT-2/CLIP.
"""

from __future__ import annotations

import gzip
import html
import os
import re

import numpy as np


def default_bpe_path():
    return os.environ.get(
        "CLIP_BPE_PATH",
        os.path.join("data", "clip_weights", "bpe_simple_vocab_16e6.txt.gz"),
    )


def bytes_to_unicode():
    """Map every byte to a printable unicode char (byte-level BPE alphabet)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
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


def basic_clean(text):
    # OpenAI's tokenizer runs ftfy.fix_text here (mojibake repair + NFC
    # normalization); ftfy is not vendored, so only the NFC half is
    # reproduced — without it, NFD-decomposed accents ('café') would
    # split at the combining mark and tokenize differently from the
    # reference. Mojibake inputs (already-corrupted encodings) remain a
    # documented divergence; the protocol's classnames/templates are clean
    # ASCII either way.
    import unicodedata

    text = unicodedata.normalize("NFC", text)
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text):
    return re.sub(r"\s+", " ", text).strip()


class SimpleTokenizer:
    def __init__(self, bpe_path: str | None = None):
        bpe_path = bpe_path or default_bpe_path()
        if not os.path.exists(bpe_path):
            raise FileNotFoundError(
                f"CLIP BPE merges file not found at {bpe_path}. Set "
                "CLIP_BPE_PATH or place bpe_simple_vocab_16e6.txt.gz there."
            )
        self.byte_encoder = bytes_to_unicode()
        merges = gzip.open(bpe_path).read().decode("utf-8").split("\n")
        merges = merges[1: 49152 - 256 - 2 + 1]
        # blank tail lines (short fixture files) must not become vocab slots
        merges = [tuple(m.split()) for m in merges if m.strip()]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        # Python re lacks \p{L}/\p{N}; the stdlib-Unicode equivalents are
        # [^\W\d_] for letters and \d for digits (so accented classnames
        # like 'café' stay one word token, as with OpenAI's regex pattern);
        # underscore counts as punctuation like the reference's
        # [^\s\p{L}\p{N}] class.
        # stdlib-re transliteration of OpenAI's \p{L}+|\p{N}|... pattern.
        # Known divergence: \d matches only Unicode Nd digits while \p{N}
        # also covers No/Nl numerics ('HALF'-style fractions, Roman
        # numerals) — such characters fall into the letter class here and
        # tokenize differently. No effect on the protocol's ASCII
        # classnames; install the third-party `regex` module and use
        # \p{L}/\p{N} if exact parity on exotic numerics matters.
        self.pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
            r"[^\W\d_]+|\d|(?:[^\w\s]|_)+",
            re.IGNORECASE,
        )

    def bpe(self, token):
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
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text):
        bpe_tokens = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(
                self.encoder[t] for t in self.bpe(token).split(" ")
            )
        return bpe_tokens

    def encode_padded(self, text, context_length=77, truncate=True):
        """SOT + BPE ids + EOT, zero-padded to ``context_length``.

        ``truncate=True`` (default) cuts over-length prompts and patches
        EOT into the last slot — the semantics of the reference path's
        ``clip.tokenize(..., truncate=True)``. Note the reference DEFAULT
        raises instead; pass ``truncate=False`` for that behavior. The
        protocol's prompt templates are far below 77 tokens either way.
        """
        sot = self.encoder["<|startoftext|>"]
        eot = self.encoder["<|endoftext|>"]
        tokens = [sot] + self.encode(text) + [eot]
        if len(tokens) > context_length:
            if not truncate:
                raise RuntimeError(
                    f"Input {text!r} is too long for context length "
                    f"{context_length}"
                )
            tokens = tokens[:context_length]
            tokens[-1] = eot
        out = np.zeros(context_length, np.int32)
        out[: len(tokens)] = tokens
        return out
