"""Seeded weights, drawn on the device by checkpoint name, for the program and the
reference alike: the group drawers of the models the families use, and the lazy
:class:`Weights` a family's ``weights`` builds from them.

Each model's tensors are named as its published checkpoint names them (BFL's
``flux1-dev.sft`` and ``ae.sft``, HF's T5EncoderModel and CLIPTextModel) and split into
groups: a flux block, a T5 layer, the VAE's encoder. A group is drawn in one call of a
generator seeded from (run seed, the model's tag, group), so any group can be drawn
again alone and gives the same bits. Every tensor comes back as a bf16 tensor of its own (never a
view of the group's draw), because bf16 is the type the configurations serve them in.

Initialisations: flux linears U(±sqrt(3/in)) with biases U(±1/sqrt(in)) and unit
qk-norm scales, and VAE convolutions He-normal with zero biases and unit group norms
(the port's own random-weight conventions); T5 and CLIP at HF's published init scales,
so that their attention logits are of a trained model's size (the port's toy towers'
N(0, 0.02²) makes T5-XXL's unscaled logits ~100 times too large).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

# init kinds: ("u", bound) uniform in ±bound, ("n", std) normal, ("ones",), ("zeros",)
Init = Tuple
Entry = Tuple[str, Tuple[int, ...], Init]  # (name, shape, init)



def group_seed(seed: int, tag: int, group: int) -> int:
    """A 63-bit generator seed for one group of the model tagged ``tag`` of a run."""
    words = np.random.SeedSequence([int(seed) & (2**64 - 1), tag, group]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


# ------------------------------------------------------------------------------- flux


def _lin(name: str, out_f: int, in_f: int, bias: bool = True) -> List[Entry]:
    out = [(f"{name}.weight", (out_f, in_f), ("u", math.sqrt(3.0 / in_f)))]
    if bias:
        out.append((f"{name}.bias", (out_f,), ("u", 1.0 / math.sqrt(in_f))))
    return out


def flux_groups(p: Dict) -> List[List[Entry]]:
    """The BFL flux checkpoint as groups: the top-level layers, then each double and
    each single block. ``p`` holds the configuration's ``params``."""
    hs = p["hidden_size"]
    mh = int(hs * p["mlp_ratio"])
    hd = hs // p["num_heads"]
    qkv_bias = p["qkv_bias"]
    top: List[Entry] = []
    top += _lin("img_in", hs, p["in_channels"])
    top += _lin("txt_in", hs, p["context_in_dim"])
    embedders = [("time_in", 256), ("vector_in", p["vec_in_dim"])]
    if p["guidance_embed"]:
        embedders.append(("guidance_in", 256))
    for name, ins in embedders:
        top += _lin(f"{name}.in_layer", hs, ins) + _lin(f"{name}.out_layer", hs, hs)
    top += _lin("final_layer.linear", p["in_channels"], hs)
    top += _lin("final_layer.adaLN_modulation.1", 2 * hs, hs)
    groups = [top]
    for i in range(p["depth"]):
        b = f"double_blocks.{i}."
        g: List[Entry] = []
        for s in ("img", "txt"):
            g += _lin(b + f"{s}_mod.lin", 6 * hs, hs)
            g += _lin(b + f"{s}_attn.qkv", 3 * hs, hs, qkv_bias)
            g += _lin(b + f"{s}_attn.proj", hs, hs)
            g += _lin(b + f"{s}_mlp.0", mh, hs) + _lin(b + f"{s}_mlp.2", hs, mh)
            g += [(b + f"{s}_attn.norm.query_norm.scale", (hd,), ("ones",)),
                  (b + f"{s}_attn.norm.key_norm.scale", (hd,), ("ones",))]
        groups.append(g)
    for i in range(p["depth_single_blocks"]):
        b = f"single_blocks.{i}."
        g = _lin(b + "linear1", 3 * hs + mh, hs) + _lin(b + "linear2", hs, hs + mh)
        g += _lin(b + "modulation.lin", 3 * hs, hs)
        g += [(b + "norm.query_norm.scale", (hd,), ("ones",)), (b + "norm.key_norm.scale", (hd,), ("ones",))]
        groups.append(g)
    return groups


# --------------------------------------------------------------------------- encoders


def t5_groups(c: Dict) -> List[List[Entry]]:
    """HF T5EncoderModel (v1.1): the embedding, position table and final norm, then
    one group per layer. Normal draws at HF's ``T5PreTrainedModel._init_weights``
    scales: the embedding 1, q (d_model·d_kv)^-1/2, k, v, wi and the position table
    d_model^-1/2, o (heads·d_kv)^-1/2, wo d_ff^-1/2; norms one."""
    d, ff, inner = c["d_model"], c["d_ff"], c["num_heads"] * c["d_kv"]
    top = [("shared.weight", (c["vocab_size"], d), ("n", 1.0)),
           ("encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight",
            (c["relative_attention_num_buckets"], c["num_heads"]), ("n", d ** -0.5)),
           ("encoder.final_layer_norm.weight", (d,), ("ones",))]
    groups = [top]
    for i in range(c["num_layers"]):
        b = f"encoder.block.{i}.layer."
        groups.append([
            (b + "0.SelfAttention.q.weight", (inner, d), ("n", (d * c["d_kv"]) ** -0.5)),
            (b + "0.SelfAttention.k.weight", (inner, d), ("n", d ** -0.5)),
            (b + "0.SelfAttention.v.weight", (inner, d), ("n", d ** -0.5)),
            (b + "0.SelfAttention.o.weight", (d, inner), ("n", inner ** -0.5)),
            (b + "0.layer_norm.weight", (d,), ("ones",)),
            (b + "1.DenseReluDense.wi_0.weight", (ff, d), ("n", d ** -0.5)),
            (b + "1.DenseReluDense.wi_1.weight", (ff, d), ("n", d ** -0.5)),
            (b + "1.DenseReluDense.wo.weight", (d, ff), ("n", ff ** -0.5)),
            (b + "1.layer_norm.weight", (d,), ("ones",)),
        ])
    return groups


def clip_groups(c: Dict) -> List[List[Entry]]:
    """HF CLIPTextModel: embeddings and final norm, then one group per layer. Normal
    draws at HF's ``CLIPPreTrainedModel._init_weights`` scales: embeddings 0.02, q, k,
    v and fc2 hidden^-1/2·(2·layers)^-1/2, out_proj hidden^-1/2, fc1 (2·hidden)^-1/2;
    biases zero, norms one."""
    d, m = c["hidden_size"], c["intermediate_size"]
    in_std = d ** -0.5 * (2 * c["num_layers"]) ** -0.5

    def lin(name, out_f, in_f, std):
        return [(f"{name}.weight", (out_f, in_f), ("n", std)), (f"{name}.bias", (out_f,), ("zeros",))]

    def ln(name):
        return [(f"{name}.weight", (d,), ("ones",)), (f"{name}.bias", (d,), ("zeros",))]

    t = "text_model."
    top = [(t + "embeddings.token_embedding.weight", (c["vocab_size"], d), ("n", 0.02)),
           (t + "embeddings.position_embedding.weight", (c["max_position_embeddings"], d), ("n", 0.02))]
    top += ln(t + "final_layer_norm")
    groups = [top]
    for i in range(c["num_layers"]):
        b = f"{t}encoder.layers.{i}."
        g = []
        for proj in ("q_proj", "k_proj", "v_proj"):
            g += lin(b + "self_attn." + proj, d, d, in_std)
        g += lin(b + "self_attn.out_proj", d, d, d ** -0.5)
        g += ln(b + "layer_norm1") + lin(b + "mlp.fc1", m, d, (2 * d) ** -0.5)
        g += lin(b + "mlp.fc2", d, m, in_std) + ln(b + "layer_norm2")
        groups.append(g)
    return groups


# -------------------------------------------------------------------------------- VAE


def ae_groups(a: Dict) -> List[List[Entry]]:
    """BFL ae.sft: the encoder, then the decoder (the reference's channel plan)."""
    ch, mult, nres = a["ch"], list(a["ch_mult"]), a["num_res_blocks"]

    def conv(name, k, cin, cout):
        return [(f"{name}.weight", (cout, cin, k, k), ("n", math.sqrt(2.0 / (k * k * cin)))),
                (f"{name}.bias", (cout,), ("zeros",))]

    def gn(name, c):
        return [(f"{name}.weight", (c,), ("ones",)), (f"{name}.bias", (c,), ("zeros",))]

    def resnet(name, cin, cout):
        g = gn(name + ".norm1", cin) + conv(name + ".conv1", 3, cin, cout)
        g += gn(name + ".norm2", cout) + conv(name + ".conv2", 3, cout, cout)
        if cin != cout:
            g += conv(name + ".nin_shortcut", 1, cin, cout)
        return g

    def mid(side, c):
        attn = f"{side}.mid.attn_1"
        g = resnet(f"{side}.mid.block_1", c, c) + gn(attn + ".norm", c)
        for n in ("q", "k", "v", "proj_out"):
            g += conv(f"{attn}.{n}", 1, c, c)
        return g + resnet(f"{side}.mid.block_2", c, c)

    enc = conv("encoder.conv_in", 3, a["in_channels"], ch)
    in_mult = [1] + mult
    block_in = ch
    for i in range(len(mult)):
        block_in = ch * in_mult[i]
        out = ch * mult[i]
        for j in range(nres):
            enc += resnet(f"encoder.down.{i}.block.{j}", block_in, out)
            block_in = out
        if i != len(mult) - 1:
            enc += conv(f"encoder.down.{i}.downsample.conv", 3, block_in, block_in)
    enc += mid("encoder", block_in) + gn("encoder.norm_out", block_in)
    enc += conv("encoder.conv_out", 3, block_in, 2 * a["z_channels"])

    block_in = ch * mult[-1]
    dec = conv("decoder.conv_in", 3, a["z_channels"], block_in) + mid("decoder", block_in)
    for i in reversed(range(len(mult))):
        out = ch * mult[i]
        for j in range(nres + 1):
            dec += resnet(f"decoder.up.{i}.block.{j}", block_in, out)
            block_in = out
        if i != 0:
            dec += conv(f"decoder.up.{i}.upsample.conv", 3, block_in, block_in)
    dec += gn("decoder.norm_out", block_in) + conv("decoder.conv_out", 3, block_in, a["out_ch"])
    return [enc, dec]


# ------------------------------------------------------------------------------- draw


def draw_group(entries: List[Entry], seed: int, tag: int, group: int,
               device) -> Dict[str, torch.Tensor]:
    """One group's tensors in bf16: a single uniform and a single normal draw over the
    group, each tensor cut from them and transformed by its init."""
    gen = torch.Generator(device=device)
    gen.manual_seed(group_seed(seed, tag, group))
    n_u = sum(math.prod(s) for _, s, init in entries if init[0] == "u")
    n_n = sum(math.prod(s) for _, s, init in entries if init[0] == "n")
    u = torch.rand(n_u, generator=gen, device=device) if n_u else None
    z = torch.randn(n_n, generator=gen, device=device) if n_n else None
    out: Dict[str, torch.Tensor] = {}
    iu = iz = 0
    for name, shape, init in entries:
        size = math.prod(shape)
        if init[0] == "u":
            t = (u[iu:iu + size] * 2 - 1) * init[1]
            iu += size
        elif init[0] == "n":
            t = z[iz:iz + size] * init[1]
            iz += size
        elif init[0] == "ones":
            t = torch.ones(size, device=device)
        else:
            t = torch.zeros(size, device=device)
        out[name] = t.to(torch.bfloat16).reshape(shape)
    return out


class Weights:
    """The tensors of one model of one run, drawn a group at a time on demand: the
    last group drawn is kept, so a loader reading in checkpoint order draws each group
    once; the first group (the small top-level layers, read at both ends of a flux
    load) is kept throughout. ``tag``, a number of the model's own within its family,
    seeds its groups apart from the other models'."""

    def __init__(self, tag: int, groups: List[List[Entry]], seed: int, device):
        self.tag, self.groups, self.seed, self.device = tag, groups, seed, torch.device(device)
        self.where = {name: gi for gi, g in enumerate(groups) for name, _, _ in g}
        self.shapes = {name: shape for g in groups for name, shape, _ in g}
        self._cache: Dict[int, Dict[str, torch.Tensor]] = {}

    def keys(self):
        return self.where.keys()

    def __contains__(self, name: str) -> bool:
        return name in self.where

    def group(self, gi: int) -> Dict[str, torch.Tensor]:
        if gi not in self._cache:
            for k in [k for k in self._cache if k != 0]:
                del self._cache[k]
            self._cache[gi] = draw_group(self.groups[gi], self.seed, self.tag, gi, self.device)
        return self._cache[gi]

    def get(self, name: str) -> torch.Tensor:
        if name not in self.where:
            raise KeyError(name)
        return self.group(self.where[name])[name]

    def release(self) -> None:
        self._cache.clear()
