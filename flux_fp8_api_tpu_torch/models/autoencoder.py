"""FLUX VAE, encode and decode (JAX counterpart: ``flux_fp8_api_tpu.models.autoencoder``;
reference modules/autoencoder.py).

The public functions keep the JAX package's NHWC layout; inside, activations are NCHW
and conv weights OIHW, torch's native layouts. GroupNorm runs in fp32. The diagonal
Gaussian draws from an explicit ``torch.Generator`` (the JAX package takes a PRNG key;
the reference uses the global ``torch.randn_like``).

Under a mesh the image can run in horizontal bands (:class:`Bands`, JAX's spatially
sharded VAE input, pipeline.py:357-369, whose halo exchange GSPMD inserts): each rank
holds its rows; a 3×3 conv first takes one halo row from each neighbour (zeros at the
image's edges), GroupNorm sums its statistics over the bands, the attention block
gathers k and v across them, and the stride-2 downsample's bottom pad row is the last
band's alone.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.quant import F8_WEIGHT_MAX, amax_to_scale
from ..utils.config import AutoEncoderParams
from ..utils.tree import ParamTree


class Bands:
    """An image's rows split over ``axes`` of ``mesh`` (one axis, or a tuple the mesh
    holds a group for): this rank holds band ``index`` of ``count``, in NCHW. Its
    collectives are counted as ``band_all_gather`` / ``band_all_reduce_sum``, apart
    from the flow's budget."""

    def __init__(self, mesh, axes):
        self.mesh, self.axes = mesh, axes
        self.count, self.index = mesh.size(axes), mesh.rank(axes)

    def rows(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This band's rows of the whole ``x`` along ``dim``."""
        return x.chunk(self.count, dim)[self.index]

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole tensor from every band's rows along ``dim``."""
        return self.mesh.all_gather(x.contiguous(), self.axes, dim, count_as="band_all_gather")

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_reduce_sum(t, self.axes, count_as="band_all_reduce_sum")

    def halo(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the row above this band, the row below it), zeros past the image's edges."""
        edges = self.gather(torch.cat([x[:, :, :1], x[:, :, -1:]], 2), 2)
        zero = torch.zeros_like(x[:, :, :1])
        i = self.index
        above = edges[:, :, 2 * i - 1:2 * i] if i > 0 else zero
        below = edges[:, :, 2 * i + 2:2 * i + 3] if i < self.count - 1 else zero
        return above, below


def _conv(p, x: torch.Tensor, stride: int = 1, padding: Optional[int] = None,
          band: Optional[Bands] = None) -> torch.Tensor:
    """Conv with an OIHW weight, which may be weight-only e4m3 (see
    :func:`quantize_ae_params`): it is dequantized in the compute dtype with its
    per-out-channel scale, as the JAX ``_conv`` does. A checkpoint may omit a bias.
    ``padding`` defaults to half the kernel on every side (JAX's "SAME" at stride 1);
    in a ``band`` the rows' half comes from the neighbours' halo rows instead."""
    w = p["weight"]
    if w.dtype == torch.float8_e4m3fn:
        w = w.to(x.dtype) * p["kscale_inv"].to(x.dtype)[:, None, None, None]
    bias = p.get("bias")
    pad = w.shape[-1] // 2 if padding is None else padding
    if band is not None and padding is None and pad:
        above, below = band.halo(x)
        x, pad = torch.cat([above, x, below], 2), (0, pad)
    return F.conv2d(x, w.to(x.dtype), None if bias is None else bias.to(x.dtype), stride=stride, padding=pad)


def _group_norm(p, x: torch.Tensor, groups: int = 32, eps: float = 1e-6,
                band: Optional[Bands] = None) -> torch.Tensor:
    """GroupNorm in fp32; in a ``band`` each group's mean and variance come from sums
    over every band (two all-reduces of (B, groups))."""
    if band is None:
        return F.group_norm(x.float(), groups, p["weight"].float(), p["bias"].float(), eps).to(x.dtype)
    b, c = x.shape[:2]
    xg = x.float().reshape(b, groups, -1)
    n = xg.shape[-1] * band.count
    mean = band.sum(xg.sum(-1)) / n
    centred = xg - mean[..., None]
    var = band.sum(centred.square().sum(-1)) / n
    y = (centred * torch.rsqrt(var[..., None] + eps)).reshape(x.shape)
    return (y * p["weight"].float()[:, None, None] + p["bias"].float()[:, None, None]).to(x.dtype)


def _swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _resnet_block(p, x: torch.Tensor, band: Optional[Bands] = None) -> torch.Tensor:
    """reference ResnetBlock (autoencoder.py:55-92)."""
    h = _conv(p["conv1"], _swish(_group_norm(p["norm1"], x, band=band)), band=band)
    h = _conv(p["conv2"], _swish(_group_norm(p["norm2"], h, band=band)), band=band)
    if "nin_shortcut" in p:
        x = _conv(p["nin_shortcut"], x)
    return x + h


def _attn_block(p, x: torch.Tensor, band: Optional[Bands] = None) -> torch.Tensor:
    """reference AttnBlock (autoencoder.py:23-52): 1×1-conv qkv and fp32 softmax
    attention over the h·w tokens. Above 4096 tokens the queries run in chunks (the
    largest divisor of l not above 2048, as in the JAX package) so the logits stay
    bounded: 16k tokens at a 1024² image would otherwise take a 1 GB logit matrix.
    In a ``band`` the band's queries attend to k and v gathered from every band."""
    h = _group_norm(p["norm"], x, band=band)
    q, k, v = (_conv(p[n], h) for n in ("q", "k", "v"))
    if band is not None:
        k, v = band.gather(k, 2), band.gather(v, 2)
    b, c, hh, ww = q.shape
    l = hh * ww
    q, k, v = (t.reshape(b, c, -1).transpose(1, 2).float() for t in (q, k, v))
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


def _downsample(p, x: torch.Tensor, band: Optional[Bands] = None) -> torch.Tensor:
    """stride-2 conv after the reference's asymmetric pad: one row at the bottom and one
    column at the right, none before (autoencoder.py:95-107). In a ``band`` (of an even
    number of rows) the row below is the next band's first, the pad row the last
    band's."""
    if band is not None:
        x = torch.cat([x, band.halo(x)[1]], 2)
        return _conv(p["conv"], F.pad(x, (0, 1, 0, 0)), stride=2, padding=0)
    return _conv(p["conv"], F.pad(x, (0, 1, 0, 1)), stride=2, padding=0)


def _upsample(p, x: torch.Tensor, band: Optional[Bands] = None) -> torch.Tensor:
    """nearest ×2 + 3×3 conv (autoencoder.py:110-120)."""
    return _conv(p["conv"], F.interpolate(x, scale_factor=2.0, mode="nearest"), band=band)


def encoder_apply(p, x: torch.Tensor, cfg: AutoEncoderParams, band: Optional[Bands] = None) -> torch.Tensor:
    """reference Encoder.forward (autoencoder.py:179-200): x (B, in_ch, H, W) NCHW →
    (B, 2·z_ch, H/8, W/8); in a ``band``, its rows of both."""
    h = _conv(p["conv_in"], x, band=band)
    n_res = len(cfg.ch_mult)
    for i_level in range(n_res):
        down = p["down"][i_level]
        for i_block in range(cfg.num_res_blocks):
            h = _resnet_block(down["block"][i_block], h, band)
        if i_level != n_res - 1:
            h = _downsample(down["downsample"], h, band)
    h = _resnet_block(p["mid"]["block_1"], h, band)
    h = _attn_block(p["mid"]["attn_1"], h, band)
    h = _resnet_block(p["mid"]["block_2"], h, band)
    return _conv(p["conv_out"], _swish(_group_norm(p["norm_out"], h, band=band)), band=band)


def decoder_apply(p, z: torch.Tensor, cfg: AutoEncoderParams, band: Optional[Bands] = None) -> torch.Tensor:
    """reference Decoder.forward (autoencoder.py:263-283): z (B, z_ch, h, w) NCHW →
    (B, out_ch, H, W); in a ``band``, its rows of both."""
    h = _conv(p["conv_in"], z, band=band)
    h = _resnet_block(p["mid"]["block_1"], h, band)
    h = _attn_block(p["mid"]["attn_1"], h, band)
    h = _resnet_block(p["mid"]["block_2"], h, band)
    for i_level in reversed(range(len(cfg.ch_mult))):
        up = p["up"][i_level]
        for i_block in range(cfg.num_res_blocks + 1):
            h = _resnet_block(up["block"][i_block], h, band)
        if i_level != 0:
            h = _upsample(up["upsample"], h, band)
    return _conv(p["conv_out"], _swish(_group_norm(p["norm_out"], h, band=band)), band=band)


def diagonal_gaussian_sample(z: torch.Tensor, generator: Optional[torch.Generator],
                             band: Optional[Bands] = None) -> torch.Tensor:
    """reference DiagonalGaussian (autoencoder.py:286-298) on channels-last moments
    (mean | logvar). ``generator=None`` returns the mean (a deterministic encode); else
    one standard normal draw of the mean's shape on the generator's device (in a
    ``band``, of the whole image's shape, and the band's rows kept)."""
    mean, logvar = z.chunk(2, dim=-1)
    if generator is None:
        return mean
    std = torch.exp(0.5 * logvar.float()).to(mean.dtype)
    shape = mean.shape if band is None else (mean.shape[0], mean.shape[1] * band.count, *mean.shape[2:])
    noise = torch.randn(shape, generator=generator, device=generator.device)
    if band is not None:
        noise = band.rows(noise, 1)
    return mean + std * noise.to(mean.device, mean.dtype)


def ae_encode(params: ParamTree, cfg: AutoEncoderParams, x: torch.Tensor,
              generator: Optional[torch.Generator] = None, band: Optional[Bands] = None) -> torch.Tensor:
    """image (B, H, W, in_ch) NHWC in [-1, 1] → latent (B, H/8, W/8, z) NHWC, with the
    scale/shift normalization (reference AutoEncoder.encode, autoencoder.py:326-328).
    In a ``band`` ``x`` is the band's rows and the whole latent, gathered from every
    band, comes back on every rank."""
    moments = encoder_apply(params["encoder"], x.permute(0, 3, 1, 2), cfg, band).permute(0, 2, 3, 1)
    z = cfg.scale_factor * (diagonal_gaussian_sample(moments, generator, band) - cfg.shift_factor)
    return z if band is None else band.gather(z, 1)


def ae_decode(params: ParamTree, cfg: AutoEncoderParams, z: torch.Tensor,
              band: Optional[Bands] = None) -> torch.Tensor:
    """latent (B, h, w, z) NHWC → image (B, H, W, out_ch) NHWC (reference
    AutoEncoder.decode, autoencoder.py:330-332); in a ``band``, its rows of both."""
    z = z / cfg.scale_factor + cfg.shift_factor
    out = decoder_apply(params["decoder"], z.permute(0, 3, 1, 2), cfg, band)
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
