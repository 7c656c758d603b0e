"""Joint-sequence attention for the FLUX DiT, BTNH layout at the public functions
(JAX counterpart: ``flux_fp8_api_tpu.ops.attention``).

Two paths, chosen by ``use_pallas`` (``FluxStatic.use_pallas``, the JAX package's
name): True runs :func:`~.attention_kernel.qknorm_attention`, the max-free kernel that
the JAX package runs in Pallas; False runs the rope pass and then
``F.scaled_dot_product_attention``, the counterpart of the JAX package's XLA attention
(``_sdpa_xla``), for weights whose qk-norm scales would overflow the max-free softmax.
Within a path, dispatch is by device: CUDA tensors launch the hand-written kernels,
CPU tensors run their plain PyTorch versions. :func:`benchmark_blocks` times the kernel
on the card.

Under a mesh (``parallel/mesh.py``) each rank's q, k and v hold only its heads, so
either path runs at the local head count with no collective. Under sequence
parallelism each rank also takes its L/sp rows of q and of the q rope tables, runs them
against the full k and v (Lq = L/sp, Lkv = L), and the output rows are all-gathered
over sp (JAX ops/attention.py:219-251, its ``shard_map`` over ``seq_axis``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .attention_kernel import qknorm_attention, rope_rotate


def fold_heads(x: torch.Tensor) -> torch.Tensor:
    """Batch folded into heads: (B, L, N, H) → (B·N, L, H). A strided view when B == 1
    (the kernels read it in place), a copy otherwise."""
    b, l, n, h = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * n, l, h)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Softmax attention of folded (B·N, L, H) q/k/v through
    ``F.scaled_dot_product_attention``, in q's dtype; float16 is upcast to fp32 first,
    as the JAX package's ``_sdpa_xla`` does. The leading axis of 1 makes the inputs
    4-D, which the fused backends on the card require."""
    dtype = q.dtype
    if dtype == torch.float16:
        q, k, v = q.float(), k.float(), v.float()
    return F.scaled_dot_product_attention(q[None], k[None], v[None])[0].to(dtype)


def attention_core(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cos: Optional[torch.Tensor] = None,
    sin: Optional[torch.Tensor] = None,
    use_pallas: bool = True,
    seq_mesh=None,
    seq_axis: Optional[str] = None,
) -> torch.Tensor:
    """Softmax attention over the joint (txt + img) sequence, optionally with rope.

    ROPE CONTRACT: the tables of batch row 0 are applied to every batch row, on both
    paths, which is valid because FLUX builds one shared position grid per batch (as
    in the JAX package's fused path).

    Args:
      q, k, v: (B, L, N, H).
      cos, sin: optional rope tables, (B, L, 1, H) as the model builds them, or (L, H).
      use_pallas: True runs the max-free kernel (the rope pass in front when there are
        tables), which has no backward and raises under a gradient; False rotates q
        and k with the rope pass and runs :func:`_sdpa`, differentiable end to end
        (the rope pass through its autograd Function and backward build, SDPA through
        its own backward): the training path.
      seq_mesh, seq_axis: sequence parallelism over ``seq_mesh``'s ``seq_axis``: this
        rank computes its L/sp q rows and all-gathers the output rows (L must divide).
    Returns:
      (B, L, N, H) in q's dtype.
    """
    b, l, n, h = q.shape
    qh, kh, vh = fold_heads(q), fold_heads(k), fold_heads(v)
    cos2d = sin2d = None
    if cos is not None:
        cos2d = (cos[0, :, 0, :] if cos.dim() == 4 else cos).float().contiguous()
        sin2d = (sin[0, :, 0, :] if sin.dim() == 4 else sin).float().contiguous()
    cos_q, sin_q = cos2d, sin2d
    sp = 1 if seq_mesh is None else seq_mesh.size(seq_axis)
    if sp > 1:
        if l % sp:
            raise ValueError(f"sequence parallelism needs L={l} divisible by sp={sp}")
        rows = slice(seq_mesh.rank(seq_axis) * (l // sp), (seq_mesh.rank(seq_axis) + 1) * (l // sp))
        qh = qh[:, rows]
        if cos2d is not None:
            cos_q, sin_q = cos2d[rows].contiguous(), sin2d[rows].contiguous()
    if use_pallas:
        out = qknorm_attention(qh, kh, vh, 1.0 / (h**0.5), cos=cos2d, sin=sin2d, cos_q=cos_q, sin_q=sin_q)
    else:
        if cos2d is not None:
            qh, kh = rope_rotate(qh, kh, cos2d, sin2d, cos_q, sin_q)
        out = _sdpa(qh, kh, vh)
    if sp > 1:
        out = seq_mesh.all_gather(out, seq_axis, dim=1)
    return out.reshape(b, n, l, h).permute(0, 2, 1, 3)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    use_pallas: bool = True,
    seq_mesh=None,
    seq_axis: Optional[str] = None,
) -> torch.Tensor:
    """RoPE + attention + head merge (reference ``attention``, flux_model.py:41-45):
    (B, L, N, H) q/k/v → (B, L, N·H)."""
    b, l, n, h = q.shape
    return attention_core(q, k, v, cos=cos, sin=sin, use_pallas=use_pallas,
                          seq_mesh=seq_mesh, seq_axis=seq_axis).reshape(b, l, n * h)


# --------------------------------------------------------------------- measurement

# GPU cycles slept per timed call before a timing, to cover the host's enqueue (~0.5 ms)
SLEEP_CYCLES_PER_CALL = 1_000_000


def cuda_device() -> torch.device:
    """The current CUDA device, or a RuntimeError where there is none: the
    measurements here time kernels on the card and never time a plain version."""
    if not torch.cuda.is_available():
        raise RuntimeError("this measurement times CUDA kernels and needs a CUDA device")
    return torch.device("cuda")


def fed_back_seconds(call, x: torch.Tensor, iters: int) -> float:
    """Per-call seconds of ``x = call(x)`` repeated ``iters`` times after one warm call,
    timed with CUDA events on the current stream. Each output is the next input, so
    no call can be skipped or overlapped with the next. The card sleeps first while the
    host enqueues the calls, so what is timed is the device, not the launch rate."""
    x = call(x)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * iters)
    start.record()
    for _ in range(iters):
        x = call(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def benchmark_blocks(
    l: int,
    folded_heads: int = 24,
    head_dim: int = 128,
    iters: int = 24,
    lkv: Optional[int] = None,
    fuse_rope: bool = True,
    ablate_exp: bool = False,
) -> float:
    """Per-call seconds of the attention call at joint seq ``l``, measured the way the
    model calls it: folded batch·head axis, the rope pass in front unless
    ``fuse_rope=False`` (the JAX name: there the rope is fused into the kernel).
    ``lkv`` (default ``l``) makes the call rectangular, the shape a sequence-parallel
    shard sees; ``ablate_exp=True`` times the build without the exp (the ceiling
    measurement of ``flux_fp8_api_tpu_torch.ablate_attention``).

    JAX counterpart: ``flux_fp8_api_tpu.ops.attention.benchmark_blocks``. The CUDA
    kernel has one compiled tile, so there are no blocks to choose. Inputs come from
    a generator seeded with 17; the fed-back output may overflow under ``ablate_exp``,
    which does not change the time. Raises RuntimeError without a CUDA device.
    """
    dev = cuda_device()
    lkv = l if lkv is None else int(lkv)
    gen = torch.Generator(device=dev).manual_seed(17)
    q = torch.randn((folded_heads, l, head_dim), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((folded_heads, lkv, head_dim), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((folded_heads, lkv, head_dim), generator=gen, device=dev).to(torch.bfloat16)

    def rope(n):  # values do not matter to the time; unit magnitude keeps exp finite
        t = torch.linspace(0.0, 1.0, n * head_dim, device=dev).reshape(n, head_dim)
        return torch.cos(t), torch.sin(t)

    rope_kw = {}
    if fuse_rope:
        (cos_q, sin_q), (cos_k, sin_k) = rope(l), rope(lkv)
        rope_kw = dict(cos=cos_k, sin=sin_k, cos_q=cos_q, sin_q=sin_q)
    sm_scale = 1.0 / head_dim**0.5
    return fed_back_seconds(
        lambda x: qknorm_attention(x, k, v, sm_scale, ablate_exp=ablate_exp, **rope_kw), q, iters
    )
