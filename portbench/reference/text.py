"""Prompt → token ids and weights, as the served configuration does it.

The tokenizer is the one the configurations assume (``configs/*.json`` ``assumed``):
a word-level vocabulary of ``<pad> <bos> <eos> <unk>``, ``tok4`` … ``tok255`` and a
short list of English words, split on ``\\w+|[^\\w\\s]+``. CLIP frames a text as
``<bos> … <eos>`` and pads with ``<eos>``; T5 appends ``<eos>`` and pads with
``<pad>``. Emphasis follows A1111's grammar (``(text)`` ×1.1, ``[text]`` ÷1.1,
``(text:w)``, ``\\(`` escapes, BREAK) and the reference's ``flux_emphasis.py``:
each segment is tokenized alone, the ids are decoded to text and encoded again, and
T5's hidden states are pulled toward the first ``<eos>`` state by each token's
weight before their mean and standard deviation are restored.
"""

from __future__ import annotations

import re
from typing import List, Tuple

import torch

WORDS = "a an the of on in photo image test beautiful cat dog house hill sun sky red blue".split()
PAD, BOS, EOS, UNK = 0, 1, 2, 3


def vocabulary() -> dict:
    vocab = {"<pad>": PAD, "<bos>": BOS, "<eos>": EOS, "<unk>": UNK}
    for i in range(4, 256):
        vocab[f"tok{i}"] = i
    for w in WORDS:
        vocab.setdefault(w, len(vocab))
    return vocab


VOCAB = vocabulary()
NAMES = {i: w for w, i in VOCAB.items()}
_SPLIT = re.compile(r"\w+|[^\w\s]+")
# the ids each style treats as special (dropped when decoding)
SPECIAL = {"clip": {BOS, EOS, UNK}, "t5": {EOS, UNK, PAD}}


def encode(text: str, style: str, special: bool = True, length: int = 0) -> List[int]:
    """Ids of ``text``; with ``special`` the style's framing; with ``length`` truncated
    and padded to it."""
    ids = [VOCAB.get(w, UNK) for w in _SPLIT.findall(text)]
    if not special:
        return ids
    head, tail, pad = ([BOS], [EOS], EOS) if style == "clip" else ([], [EOS], PAD)
    if length:
        ids = ids[:length - len(head) - len(tail)]
    ids = head + ids + tail
    return ids + [pad] * (length - len(ids)) if length else ids


def decode(ids: List[int], style: str) -> str:
    """Skipping the style's special ids, words joined by spaces, with transformers'
    clean-up of spaces before punctuation and contractions."""
    out = " ".join(NAMES[i] for i in ids if i not in SPECIAL[style])
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                 (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
        out = out.replace(a, b)
    return out


_ATTENTION = re.compile(r"\\\(|\\\)|\\\[|\\]|\\\\|\\|\(|\[|:([+-]?[.\d]+)\)|\)|]|[^\\()\[\]:]+|:")
_BREAK = re.compile(r"\s*\bBREAK\b\s*", re.S)


def parse_attention(text: str) -> List[List]:
    """A1111's ``parse_prompt_attention``: [[text, weight], ...], neighbours of equal
    weight merged."""
    res: List[List] = []
    round_open: List[int] = []
    square_open: List[int] = []

    def multiply(start: int, m: float) -> None:
        for p in range(start, len(res)):
            res[p][1] *= m

    for m in _ATTENTION.finditer(text):
        tok, weight = m.group(0), m.group(1)
        if tok.startswith("\\"):
            res.append([tok[1:], 1.0])
        elif tok == "(":
            round_open.append(len(res))
        elif tok == "[":
            square_open.append(len(res))
        elif weight is not None and round_open:
            try:
                w = float(weight)
            except ValueError:
                w = 1.0
            multiply(round_open.pop(), w)
        elif tok == ")" and round_open:
            multiply(round_open.pop(), 1.1)
        elif tok == "]" and square_open:
            multiply(square_open.pop(), 1 / 1.1)
        else:
            for i, part in enumerate(_BREAK.split(tok)):
                if i > 0:
                    res.append(["BREAK", -1])
                res.append([part, 1.0])
    for pos in round_open:
        multiply(pos, 1.1)
    for pos in square_open:
        multiply(pos, 1 / 1.1)
    if not res:
        return [["", 1.0]]
    merged = [res[0]]
    for t, w in res[1:]:
        if merged[-1][1] == w:
            merged[-1][0] += t
        else:
            merged.append([t, w])
    return merged


def weighted_tokens(prompt: str, style: str) -> Tuple[List[int], List[float]]:
    ids: List[int] = []
    weights: List[float] = []
    for seg, w in parse_attention(prompt):
        seg_ids = encode(seg, style, special=False)
        ids += seg_ids
        weights += [w] * len(seg_ids)
    return ids, weights


def clip_ids(prompt: str, length: int = 77) -> List[int]:
    """The CLIP ids the served path encodes: the weighted tokens chunked and framed
    (flux_emphasis.py:177-245: a block of ``length`` tokens, as ``length`` is not
    below 77), decoded and encoded again."""
    ids, _ = weighted_tokens(prompt, "clip")
    chunks = []
    while len(ids) >= length:
        chunks += [BOS] + ids[:length] + [EOS]
        ids = ids[length:]
    if ids:
        chunks += [BOS] + ids + [EOS] * (length - len(ids)) + [EOS]
    return encode(decode(chunks, "clip"), "clip", length=length)


def t5_ids_and_weights(prompt: str, length: int) -> Tuple[List[int], List[float]]:
    """The T5 ids the served path encodes, and the per-position weights it applies
    (unframed chunks, decoded and encoded again; weights padded with 1.0)."""
    ids, weights = weighted_tokens(prompt, "t5")
    final = encode(decode(ids, "t5"), "t5", length=length)
    return final, (weights + [1.0] * max(0, length - len(weights)))[:length]


def apply_weights(ids: torch.Tensor, weights: torch.Tensor, hidden: torch.Tensor) -> torch.Tensor:
    """Each token's state pulled toward the first ``<eos>`` state by its weight, then
    the whole tensor's mean and (population) standard deviation restored."""
    h = hidden.float()
    mean, std = h.mean(), h.std(correction=0)
    eos = int(torch.argmax((ids == EOS).to(torch.int32)))
    pooled = h[:, eos:eos + 1]
    out = pooled + (h - pooled) * weights.float()[None, :, None]
    return (out - out.mean()) / out.std(correction=0) * std + mean
