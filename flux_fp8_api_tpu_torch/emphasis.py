"""A1111-style prompt emphasis → weighted CLIP/T5 embeddings
(JAX counterpart: ``flux_fp8_api_tpu.emphasis``; reference ``flux_emphasis.py``).

The grammar, tokenisation and chunking are plain Python and identical to the JAX
package's; the embedding arithmetic is in torch. ``jnp.std`` is the population std,
hence ``correction=0`` below.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

import torch

_ATTENTION_RE = re.compile(
    r"""
        \\\(|\\\)|\\\[|\\]|\\\\|\\|\(|\[|:([+-]?[.\d]+)\)|
        \)|]|[^\\()\[\]:]+|:
    """,
    re.X,
)
_BREAK_RE = re.compile(r"\s*\bBREAK\b\s*", re.S)

ROUND_MULTIPLIER = 1.1
SQUARE_MULTIPLIER = 1 / 1.1


def parse_prompt_attention(text: str) -> List[List]:
    """Parse emphasis syntax into [text, weight] pairs.

    >>> parse_prompt_attention('an (important) word')
    [['an ', 1.0], ['important', 1.1], [' word', 1.0]]
    """
    segments: List[List] = []
    round_stack: List[int] = []
    square_stack: List[int] = []

    def scale_from(start: int, multiplier: float) -> None:
        for seg in segments[start:]:
            seg[1] *= multiplier

    for m in _ATTENTION_RE.finditer(text):
        tok = m.group(0)
        explicit_weight = m.group(1)
        if tok.startswith("\\"):
            segments.append([tok[1:], 1.0])
        elif tok == "(":
            round_stack.append(len(segments))
        elif tok == "[":
            square_stack.append(len(segments))
        elif explicit_weight is not None and round_stack:
            # the regex admits a bare "." — an unparsable weight counts as 1.0
            try:
                weight = float(explicit_weight)
            except ValueError:
                weight = 1.0
            scale_from(round_stack.pop(), weight)
        elif tok == ")" and round_stack:
            scale_from(round_stack.pop(), ROUND_MULTIPLIER)
        elif tok == "]" and square_stack:
            scale_from(square_stack.pop(), SQUARE_MULTIPLIER)
        else:
            parts = _BREAK_RE.split(tok)
            for i, part in enumerate(parts):
                if i > 0:
                    segments.append(["BREAK", -1])
                segments.append([part, 1.0])

    # unbalanced opener brackets still emphasize to end-of-prompt
    for pos in round_stack:
        scale_from(pos, ROUND_MULTIPLIER)
    for pos in square_stack:
        scale_from(pos, SQUARE_MULTIPLIER)

    if not segments:
        return [["", 1.0]]

    merged: List[List] = [segments[0]]
    for text_seg, w in segments[1:]:
        if merged[-1][1] == w:
            merged[-1][0] += text_seg
        else:
            merged.append([text_seg, w])
    return merged


def tokenize_with_weights(tokenizer, prompt: str) -> Tuple[List[int], List[float]]:
    """Tokenize each parsed segment without special tokens, expanding its weight over
    the segment's tokens (reference flux_emphasis.py:114-174)."""
    tokens: List[int] = []
    weights: List[float] = []
    for word, weight in parse_prompt_attention(prompt):
        ids = tokenizer(word, truncation=False, padding=False, add_special_tokens=False).input_ids
        tokens.extend(ids)
        weights.extend([weight] * len(ids))
    return tokens, weights


def group_tokens_and_weights(
    token_ids: List[int],
    weights: List[float],
    pad_last_block: bool = False,
    bos: Optional[int] = 49406,
    eos: int = 49407,
    max_length: int = 77,
    pad_tokens: bool = True,
) -> Tuple[List[List[int]], List[List[float]]]:
    """Chunk into max_length groups with BOS/EOS framing (reference
    flux_emphasis.py:177-245, including its quirk of only reserving BOS/EOS room when
    max_length < 77)."""
    token_ids = list(token_ids)
    weights = list(weights)
    max_len = max_length - 2 if max_length < 77 else max_length
    out_ids: List[List[int]] = []
    out_weights: List[List[float]] = []
    while len(token_ids) >= max_len:
        chunk_ids = [token_ids.pop(0) for _ in range(max_len)]
        chunk_w = [weights.pop(0) for _ in range(max_len)]
        if pad_tokens:
            if bos is not None:
                chunk_ids = [bos] + chunk_ids + [eos]
                chunk_w = [1.0] + chunk_w + [1.0]
            else:
                chunk_ids = chunk_ids + [eos]
                chunk_w = chunk_w + [1.0]
        out_ids.append(chunk_ids)
        out_weights.append(chunk_w)
    if token_ids:
        if pad_tokens:
            padding_len = max_len - len(token_ids) if pad_last_block else 0
            head_ids = [bos] if bos is not None else []
            head_w = [1.0] if bos is not None else []
            out_ids.append(head_ids + token_ids + [eos] * padding_len + [eos])
            out_weights.append(head_w + weights + [1.0] * padding_len + [1.0])
        else:
            out_ids.append(token_ids)
            out_weights.append(weights)
    return out_ids, out_weights


def standardize_tensor(x: torch.Tensor, target_mean: torch.Tensor, target_std: torch.Tensor) -> torch.Tensor:
    """Restore a target mean/std after weighting (flux_emphasis.py:248-273)."""
    x32 = x.float()
    standardized = (x32 - x32.mean()) / x32.std(correction=0)
    return (standardized * target_std + target_mean).to(x.dtype)


def apply_weights(
    prompt_tokens: torch.Tensor,
    weights: torch.Tensor,
    token_embedding: torch.Tensor,
    eos_token_id: int,
) -> torch.Tensor:
    """Lerp each token's embedding toward the pooled (first-EOS) embedding by its
    weight, then restore the tensor's mean/std (flux_emphasis.py:276-304)."""
    emb32 = token_embedding.float()
    mean, std = emb32.mean(), emb32.std(correction=0)
    eos_pos = torch.argmax((prompt_tokens == eos_token_id).to(torch.int32), dim=-1)
    pooled = emb32[torch.arange(emb32.shape[0], device=emb32.device), eos_pos][:, None, :]
    w = weights.float()[None, :, None]
    weighted = pooled + (emb32 - pooled) * w
    return standardize_tensor(weighted, mean, std).to(token_embedding.dtype)


def get_weighted_text_embeddings(
    clip_encoder,
    t5_encoder,
    prompt: str,
    num_images_per_prompt: int = 1,
    t5_length: int = 512,
    clip_length: int = 77,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dual-encoder weighted embedding (reference get_weighted_text_embeddings_flux,
    flux_emphasis.py:307-447) → (clip_pooled (B, 768), t5_weighted (B, t5_length, 4096)),
    each on its encoder's device."""
    tok_clip, w_clip = tokenize_with_weights(clip_encoder.tokenizer, prompt)
    tok_t5, w_t5 = tokenize_with_weights(t5_encoder.tokenizer, prompt)

    ids_clip, _ = group_tokens_and_weights(
        tok_clip, w_clip, pad_last_block=True,
        bos=clip_encoder.tokenizer.bos_token_id, eos=clip_encoder.tokenizer.eos_token_id,
        max_length=clip_length,
    )
    ids_t5, ws_t5 = group_tokens_and_weights(
        tok_t5, w_t5, pad_last_block=True,
        bos=t5_encoder.tokenizer.bos_token_id, eos=t5_encoder.tokenizer.eos_token_id,
        max_length=t5_length, pad_tokens=False,
    )
    flat_ids_clip = [t for chunk in ids_clip for t in chunk]
    flat_ids_t5 = [t for chunk in ids_t5 for t in chunk]
    flat_w_t5 = [w for chunk in ws_t5 for w in chunk]

    # decode → re-encode round trip (flux_emphasis.py:381-402)
    text_clip = clip_encoder.tokenizer.decode(
        flat_ids_clip, skip_special_tokens=True, clean_up_tokenization_spaces=True
    )
    ids_clip_final = clip_encoder.tokenizer(
        text_clip, add_special_tokens=True, padding="max_length", truncation=True,
        max_length=clip_length, return_tensors="np",
    ).input_ids
    text_t5 = t5_encoder.tokenizer.decode(
        flat_ids_t5, skip_special_tokens=True, clean_up_tokenization_spaces=True
    )
    ids_t5_final = t5_encoder.tokenizer(
        text_t5, add_special_tokens=True, padding="max_length", truncation=True,
        max_length=t5_length, return_tensors="np",
    ).input_ids

    w_t5_list = (flat_w_t5 + [1.0] * max(0, t5_length - len(flat_w_t5)))[:t5_length]

    clip_pooled = clip_encoder.encode_ids(ids_clip_final)  # (1, 768)
    t5_hidden = t5_encoder.encode_ids(ids_t5_final)  # (1, L, 4096)
    dev = t5_hidden.device
    t5_weighted = apply_weights(
        torch.as_tensor(ids_t5_final, device=dev),
        torch.tensor(w_t5_list, dtype=torch.float32, device=dev),
        t5_hidden,
        t5_encoder.tokenizer.eos_token_id,
    )
    if num_images_per_prompt > 1:
        clip_pooled = clip_pooled.repeat_interleave(num_images_per_prompt, dim=0)
        t5_weighted = t5_weighted.repeat_interleave(num_images_per_prompt, dim=0)
    return clip_pooled, t5_weighted
