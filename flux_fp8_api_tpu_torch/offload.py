"""Streamed host offload of the flow (JAX counterpart: ``flux_fp8_api_tpu.offload``).

The reference's 24 GB plan keeps the flow on the host and moves it to the card as
compute reaches it (``float8_quantize.py:427-446``, ``flux_pipeline.py:624-656``).
Here, as in the JAX package:

- the top-level params (embedders, final layer: about 0.1 GB at flux-dev width) go to
  the card once per stream state and stay there;
- the double and single blocks stay on the host, in page-locked memory;
- the denoise loop copies block *j+1* to the card on a side stream before it launches
  block *j*, so each copy runs under the compute before it; the compute stream waits
  for a block's copy event before its first kernel;
- copied blocks are retained on the card for the later steps, all of them or the
  leading ones within ``retain_bytes``; the others are dropped once their compute is
  enqueued and copied again at the next step;
- every device copy dies when the loop returns. Nothing is copied back and the host
  tree is never replaced: the card's memory is free for the VAE and the text encoders
  again at no cost.

The port's blocks are separate modules already (``model["double_blocks"][i]``), so
the JAX package's ``LazyBlockSlices``, which slices one block out of its depth-stacked
leaves, has no counterpart: a block's device copy is :func:`~.utils.tree.tree_to` of
that module. The JAX package's four jitted step pieces (``make_stream_fns``) are the
functions the resident forward is built from (``models/flux.py``: ``flux_pre``,
``_double_block``, ``_single_block``, ``flux_final``), so a streamed step launches the
same kernels in the same order as a resident one and gives its values bit for bit.

Each device tensor of a copied block is allocated on the side stream and read on the
compute stream, so each gets ``record_stream(compute)``: without it the caching
allocator could hand a dropped block's memory to the next copy while the block's
kernels still read it.
"""

from __future__ import annotations

import collections
import functools
import itertools
from typing import Dict, List, Optional, Tuple

import torch

from .models.flux import FluxStatic, _double_block, _single_block, _Tape, flux_final, flux_pre
from .sampling import _euler, _guidance_vec, _update
from .utils.tree import tree_nbytes, tree_to

BLOCK_STACKS = ("double_blocks", "single_blocks")


@functools.lru_cache(maxsize=None)
def side_stream(device: torch.device) -> "torch.cuda.Stream":
    """One copy stream per card for the process: the caching allocator keeps a pool
    per stream, so a new stream per call would strand each call's freed blocks in a
    pool of their own."""
    return torch.cuda.Stream(device)


class BlockStream:
    """Copies blocks host → ``device`` on a side stream for the current (compute)
    stream; on the CPU a copy is the host block itself and nothing waits.

    ``sync_every`` is host backpressure, as in the JAX package, which fetches a value
    of the newest activation every ``sync_every`` puts and so drains the queue to the
    compute frontier (JAX offload.py:177-187, 254-259): the loop calls
    :meth:`computed` once each block's compute is enqueued, which records an event on
    the compute stream tagged with the puts made so far, and the n-th put first waits
    for every compute recorded ``sync_every`` − 1 or more puts before it (the loop has
    put block j + 1 by the time block j's compute is recorded, so at retain 0 that is
    the compute of block n − ``sync_every``). Counting puts, not computes, keeps the
    bound where retained blocks compute with no put. That bounds how far the host runs
    ahead of the compute, and so how many dropped blocks the allocator holds that it
    cannot reuse yet. 0 never waits. It changes no value."""

    def __init__(self, device, sync_every: int = 0):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.sync_every = sync_every
        self._pending: collections.deque = collections.deque()  # (puts made, compute event)
        self._puts = 0
        if self.cuda:
            self.compute = torch.cuda.current_stream(self.device)
            self.side = side_stream(self.device)

    def put(self, block: torch.nn.Module) -> Tuple[torch.nn.Module, Optional[torch.cuda.Event]]:
        """Enqueue the block's copy → (device copy, its copy event or None)."""
        if not self.cuda:
            return tree_to(block, self.device), None
        self._puts += 1
        while self._pending and self._pending[0][0] <= self._puts - self.sync_every + 1:
            self._pending.popleft()[1].synchronize()
        with torch.cuda.stream(self.side):
            dev = tree_to(block, self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.side)
        for b in dev.buffers():
            b.record_stream(self.compute)
        return dev, done

    def computed(self) -> None:
        """Mark one block's compute as enqueued (see ``sync_every``)."""
        if self.cuda and self.sync_every:
            ev = torch.cuda.Event()
            ev.record(self.compute)
            self._pending.append((self._puts, ev))

    def ready(self, done: Optional[torch.cuda.Event]) -> None:
        """Make the compute stream wait for a copy before its next kernel."""
        if done is not None:
            self.compute.wait_event(done)


def split_flow_params(model) -> Tuple[Dict[str, Optional[torch.nn.Module]], torch.nn.ModuleList, torch.nn.ModuleList]:
    """Flow tree → (top-level entries by name, double blocks, single blocks). A None
    entry (a schnell tree's ``guidance_in``) stays None."""
    tops = {k: v for k, v in model.items() if k not in BLOCK_STACKS}
    return tops, model["double_blocks"], model["single_blocks"]


def slice_nbytes(blocks) -> int:
    """Bytes of one block of a stack (the stack's bytes / depth): the unit the
    ``retain_bytes`` budget is charged in."""
    return sum(tree_nbytes(b) for b in blocks) // max(len(blocks), 1)


def tops_to_device(tops: Dict[str, Optional[torch.nn.Module]], device) -> Dict[str, Optional[torch.nn.Module]]:
    """Device copies of the top-level entries, made on the current stream."""
    return {k: None if v is None else tree_to(v, device, non_blocking=True) for k, v in tops.items()}


def retained_blocks(dbl, sgl, retain_bytes: Optional[int]) -> List[bool]:
    """Which blocks stay on the card between steps: all (None), or the leading ones
    whose summed slice bytes fit ``retain_bytes``."""
    n = len(dbl) + len(sgl)
    if retain_bytes is None:
        return [True] * n
    sizes = [slice_nbytes(dbl)] * len(dbl) + [slice_nbytes(sgl)] * len(sgl)
    return [cum <= retain_bytes for cum in itertools.accumulate(sizes)]


def streamed_denoise(
    tops_dev,
    dbl_blocks,
    sgl_blocks,
    device,
    img: torch.Tensor,
    img_ids: torch.Tensor,
    txt: torch.Tensor,
    txt_ids: torch.Tensor,
    y: torch.Tensor,
    timesteps,
    guidance: float,
    cfg: FluxStatic,
    progress: bool = False,
    retain_bytes: Optional[int] = None,
    sync_every: int = 8,
) -> torch.Tensor:
    """The Euler denoise loop with the blocks streamed from the host tree: at step 1
    each block's copy runs under the compute of the block before it; retained blocks
    run resident at the later steps, the others are copied again one block ahead.

    ``tops_dev``: the top-level entries on ``device`` (:func:`tops_to_device`);
    ``dbl_blocks``/``sgl_blocks``: the host blocks. ``retain_bytes`` caps the block
    bytes kept on the card between steps (None keeps all; 0 re-streams every block
    every step, a rolling window of a few blocks). ``sync_every``: see
    :class:`BlockStream`. The latents equal the resident loop's
    (``sampling.denoise``) bit for bit at every budget."""
    pairs = list(zip(timesteps[:-1], timesteps[1:]))
    if progress:
        from tqdm import tqdm

        pairs = tqdm(pairs, desc="denoise (streamed offload)")
    blocks = list(dbl_blocks) + list(sgl_blocks)
    n_dbl, n = len(dbl_blocks), len(dbl_blocks) + len(sgl_blocks)
    retained = retained_blocks(dbl_blocks, sgl_blocks, retain_bytes)
    stream = BlockStream(device, sync_every)
    dev: List[Optional[torch.nn.Module]] = [None] * n
    done: List[Optional[torch.cuda.Event]] = [None] * n

    def take(j: int) -> torch.nn.Module:
        """Block j's device copy, block j+1's copy enqueued first; a block not
        retained is dropped here and freed once its compute is enqueued."""
        for i in (j, j + 1):
            if i < n and dev[i] is None:
                dev[i], done[i] = stream.put(blocks[i])
        stream.ready(done[j])
        done[j] = None
        blk = dev[j]
        if not retained[j]:
            dev[j] = None
        return blk

    g_vec = _guidance_vec(cfg, img, guidance)
    tape = _Tape(False, cfg.fp8_fast_accum)
    txt_len = txt.shape[1]
    for t_curr, t_prev in pairs:
        t_vec, dt = _euler(cfg, img, t_curr, t_prev)
        img_e, txt_e, vec_silu, cos, sin = flux_pre(tops_dev, cfg, img, img_ids, txt, txt_ids, t_vec, y, g_vec, tape)
        for j in range(n_dbl):
            img_e, txt_e = _double_block(cfg, take(j), img_e, txt_e, vec_silu, cos, sin, tape)
            stream.computed()
        x = torch.cat([txt_e, img_e], dim=1)
        for j in range(n_dbl, n):
            x = _single_block(cfg, take(j), x, vec_silu, cos, sin, tape)
            stream.computed()
        img = _update(img, dt, flux_final(tops_dev, cfg, x[:, txt_len:], vec_silu, tape))
    return img
