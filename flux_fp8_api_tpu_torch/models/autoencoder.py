"""FLUX VAE, encode and decode (JAX counterpart: ``flux_fp8_api_tpu.models.autoencoder``;
reference modules/autoencoder.py).

The public functions keep the JAX package's NHWC layout; inside, activations are NCHW
and conv weights OIHW, torch's native layouts. GroupNorm runs in fp32. The diagonal
Gaussian draws from an explicit ``torch.Generator`` (the JAX package takes a PRNG key;
the reference uses the global ``torch.randn_like``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.quant import F8_WEIGHT_MAX, amax_to_scale
from ..utils.config import AutoEncoderParams
from ..utils.tree import ParamTree


def _conv(p, x: torch.Tensor, stride: int = 1, padding: Optional[int] = None) -> torch.Tensor:
    """Conv with an OIHW weight, which may be weight-only e4m3 (see
    :func:`quantize_ae_params`): it is dequantized in the compute dtype with its
    per-out-channel scale, as the JAX ``_conv`` does. A checkpoint may omit a bias.
    ``padding`` defaults to half the kernel on every side (JAX's "SAME" at stride 1)."""
    w = p["weight"]
    if w.dtype == torch.float8_e4m3fn:
        w = w.to(x.dtype) * p["kscale_inv"].to(x.dtype)[:, None, None, None]
    bias = p.get("bias")
    return F.conv2d(x, w.to(x.dtype), None if bias is None else bias.to(x.dtype),
                    stride=stride, padding=w.shape[-1] // 2 if padding is None else padding)


def _group_norm(p, x: torch.Tensor, groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    return F.group_norm(x.float(), groups, p["weight"].float(), p["bias"].float(), eps).to(x.dtype)


def _swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _resnet_block(p, x: torch.Tensor) -> torch.Tensor:
    """reference ResnetBlock (autoencoder.py:55-92)."""
    h = _conv(p["conv1"], _swish(_group_norm(p["norm1"], x)))
    h = _conv(p["conv2"], _swish(_group_norm(p["norm2"], h)))
    if "nin_shortcut" in p:
        x = _conv(p["nin_shortcut"], x)
    return x + h


def _attn_block(p, x: torch.Tensor) -> torch.Tensor:
    """reference AttnBlock (autoencoder.py:23-52): 1×1-conv qkv and fp32 softmax
    attention over the h·w tokens. Above 4096 tokens the queries run in chunks (the
    largest divisor of l not above 2048, as in the JAX package) so the logits stay
    bounded: 16k tokens at a 1024² image would otherwise take a 1 GB logit matrix."""
    h = _group_norm(p["norm"], x)
    q, k, v = (_conv(p[n], h) for n in ("q", "k", "v"))
    b, c, hh, ww = q.shape
    l = hh * ww
    q, k, v = (t.reshape(b, c, l).transpose(1, 2).float() for t in (q, k, v))
    scale = c**-0.5
    chunk = next((n for n in range(2048, 255, -1) if l % n == 0), None)
    if l <= 4096 or chunk is None:
        chunk = l
    out = torch.cat([
        torch.softmax(torch.matmul(q[:, i:i + chunk], k.transpose(1, 2)) * scale, dim=-1) @ v
        for i in range(0, l, chunk)
    ], dim=1)
    out = out.to(x.dtype).transpose(1, 2).reshape(b, c, hh, ww)
    return x + _conv(p["proj_out"], out)


def _downsample(p, x: torch.Tensor) -> torch.Tensor:
    """stride-2 conv after the reference's asymmetric pad: one row at the bottom and one
    column at the right, none before (autoencoder.py:95-107)."""
    return _conv(p["conv"], F.pad(x, (0, 1, 0, 1)), stride=2, padding=0)


def _upsample(p, x: torch.Tensor) -> torch.Tensor:
    """nearest ×2 + 3×3 conv (autoencoder.py:110-120)."""
    return _conv(p["conv"], F.interpolate(x, scale_factor=2.0, mode="nearest"))


def encoder_apply(p, x: torch.Tensor, cfg: AutoEncoderParams) -> torch.Tensor:
    """reference Encoder.forward (autoencoder.py:179-200): x (B, in_ch, H, W) NCHW →
    (B, 2·z_ch, H/8, W/8)."""
    h = _conv(p["conv_in"], x)
    n_res = len(cfg.ch_mult)
    for i_level in range(n_res):
        down = p["down"][i_level]
        for i_block in range(cfg.num_res_blocks):
            h = _resnet_block(down["block"][i_block], h)
        if i_level != n_res - 1:
            h = _downsample(down["downsample"], h)
    h = _resnet_block(p["mid"]["block_1"], h)
    h = _attn_block(p["mid"]["attn_1"], h)
    h = _resnet_block(p["mid"]["block_2"], h)
    return _conv(p["conv_out"], _swish(_group_norm(p["norm_out"], h)))


def decoder_apply(p, z: torch.Tensor, cfg: AutoEncoderParams) -> torch.Tensor:
    """reference Decoder.forward (autoencoder.py:263-283): z (B, z_ch, h, w) NCHW →
    (B, out_ch, H, W)."""
    h = _conv(p["conv_in"], z)
    h = _resnet_block(p["mid"]["block_1"], h)
    h = _attn_block(p["mid"]["attn_1"], h)
    h = _resnet_block(p["mid"]["block_2"], h)
    for i_level in reversed(range(len(cfg.ch_mult))):
        up = p["up"][i_level]
        for i_block in range(cfg.num_res_blocks + 1):
            h = _resnet_block(up["block"][i_block], h)
        if i_level != 0:
            h = _upsample(up["upsample"], h)
    return _conv(p["conv_out"], _swish(_group_norm(p["norm_out"], h)))


def diagonal_gaussian_sample(z: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """reference DiagonalGaussian (autoencoder.py:286-298) on channels-last moments
    (mean | logvar). ``generator=None`` returns the mean (a deterministic encode); else
    one standard normal draw of the mean's shape on the generator's device."""
    mean, logvar = z.chunk(2, dim=-1)
    if generator is None:
        return mean
    std = torch.exp(0.5 * logvar.float()).to(mean.dtype)
    noise = torch.randn(mean.shape, generator=generator, device=generator.device)
    return mean + std * noise.to(mean.device, mean.dtype)


def ae_encode(params: ParamTree, cfg: AutoEncoderParams, x: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """image (B, H, W, in_ch) NHWC in [-1, 1] → latent (B, H/8, W/8, z) NHWC, with the
    scale/shift normalization (reference AutoEncoder.encode, autoencoder.py:326-328)."""
    moments = encoder_apply(params["encoder"], x.permute(0, 3, 1, 2), cfg).permute(0, 2, 3, 1)
    z = diagonal_gaussian_sample(moments, generator)
    return cfg.scale_factor * (z - cfg.shift_factor)


def ae_decode(params: ParamTree, cfg: AutoEncoderParams, z: torch.Tensor) -> torch.Tensor:
    """latent (B, h, w, z) NHWC → image (B, H, W, out_ch) NHWC (reference
    AutoEncoder.decode, autoencoder.py:330-332)."""
    z = z / cfg.scale_factor + cfg.shift_factor
    out = decoder_apply(params["decoder"], z.permute(0, 3, 1, 2), cfg)
    return out.permute(0, 2, 3, 1)


# ---------------------------------------------------------------- weight-only quant


def quantize_ae_params(params: ParamTree) -> ParamTree:
    """Weight-only e4m3 quantization of every conv weight with per-out-channel scales,
    in place (JAX ``quantize_ae_params``: what the reference's ``ae_quantization_dtype``
    advertises, util.py:288-291, where it finds no nn.Linear and does nothing).
    :func:`_conv` dequantizes at use; AE parameter memory halves."""

    def walk(node: torch.nn.Module) -> None:
        for key, child in list(node.named_children()):
            w = child.get("weight") if isinstance(child, ParamTree) else None
            if w is not None and w.dim() == 4 and w.dtype != torch.float8_e4m3fn:
                w32 = w.float()
                scale = amax_to_scale(w32.abs().amax(dim=(1, 2, 3)), F8_WEIGHT_MAX)  # (out,)
                q = torch.clamp(w32 * scale[:, None, None, None], -F8_WEIGHT_MAX, F8_WEIGHT_MAX)
                entries = dict(child.items())
                entries.update(weight=q.to(torch.float8_e4m3fn), kscale_inv=1.0 / scale)
                setattr(node, key, ParamTree(entries))
            else:
                walk(child)

    walk(params)
    return params


# ------------------------------------------------------------------------- param init


def init_autoencoder_params(
    cfg: AutoEncoderParams, generator: torch.Generator, dtype=torch.float32
) -> ParamTree:
    """Random init with the reference's channel plan (Encoder autoencoder.py:123-177,
    Decoder :203-261): He-normal conv weights, zero biases, unit GroupNorm."""
    device = generator.device

    def conv(k, cin, cout):
        std = (2.0 / (k * k * cin)) ** 0.5
        w = torch.randn((cout, cin, k, k), generator=generator, device=device) * std
        return {"weight": w.to(dtype), "bias": torch.zeros((cout,), dtype=dtype, device=device)}

    def gn(c):
        return {"weight": torch.ones((c,), dtype=dtype, device=device),
                "bias": torch.zeros((c,), dtype=dtype, device=device)}

    def resnet(cin, cout):
        p = {"norm1": gn(cin), "conv1": conv(3, cin, cout), "norm2": gn(cout), "conv2": conv(3, cout, cout)}
        if cin != cout:
            p["nin_shortcut"] = conv(1, cin, cout)
        return p

    def attn(c):
        return {"norm": gn(c), "q": conv(1, c, c), "k": conv(1, c, c), "v": conv(1, c, c),
                "proj_out": conv(1, c, c)}

    ch, n_res = cfg.ch, len(cfg.ch_mult)
    in_ch_mult = (1,) + tuple(cfg.ch_mult)

    enc: Dict[str, Any] = {"conv_in": conv(3, cfg.in_channels, ch)}
    down = []
    block_in = ch
    for i_level in range(n_res):
        block_in = ch * in_ch_mult[i_level]
        block_out = ch * cfg.ch_mult[i_level]
        level: Dict[str, Any] = {"block": []}
        for _ in range(cfg.num_res_blocks):
            level["block"].append(resnet(block_in, block_out))
            block_in = block_out
        if i_level != n_res - 1:
            level["downsample"] = {"conv": conv(3, block_in, block_in)}
        down.append(level)
    enc["down"] = down
    enc["mid"] = {"block_1": resnet(block_in, block_in), "attn_1": attn(block_in),
                  "block_2": resnet(block_in, block_in)}
    enc["norm_out"] = gn(block_in)
    enc["conv_out"] = conv(3, block_in, 2 * cfg.z_channels)

    block_in = ch * cfg.ch_mult[n_res - 1]
    dec: Dict[str, Any] = {"conv_in": conv(3, cfg.z_channels, block_in)}
    dec["mid"] = {"block_1": resnet(block_in, block_in), "attn_1": attn(block_in),
                  "block_2": resnet(block_in, block_in)}
    up: list = [None] * n_res
    for i_level in reversed(range(n_res)):
        block_out = ch * cfg.ch_mult[i_level]
        level = {"block": []}
        for _ in range(cfg.num_res_blocks + 1):
            level["block"].append(resnet(block_in, block_out))
            block_in = block_out
        if i_level != 0:
            level["upsample"] = {"conv": conv(3, block_in, block_in)}
        up[i_level] = level
    dec["up"] = up
    dec["norm_out"] = gn(block_in)
    dec["conv_out"] = conv(3, block_in, cfg.out_ch)
    return ParamTree({"encoder": enc, "decoder": dec})
