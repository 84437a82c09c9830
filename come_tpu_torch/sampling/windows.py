"""Vectorized skip-gram window-pair extraction.

Port of ``come_tpu/sampling/windows.py``.  Walks ``[B, L]`` become dense
pair tensors ``centers/contexts/mask [B, L, 2W]`` (offsets -W..-1, 1..W):
invalid pairs are masked, not dropped, so shapes stay fixed.

  * reduced window: per center position a draw ``b ~ U{0..W-1}``; only
    offsets with ``|o| <= W - b`` train.
  * frequent-node subsampling: each occurrence is kept with the word2vec
    keep-probability (draw ``u ~ U[0, 1)`` per position, kept if
    ``u < keep[node]``); a pair trains only if both ends are kept.  The
    reference removes dropped words so windows span across them; this masks
    the pair instead (the JAX package's documented difference).

The two draws (``b`` and ``u``) can be passed in, so a test can feed the
port the draws the JAX package makes from its key; without them they come
from a ``torch.Generator``.
"""

from __future__ import annotations

import numpy as np
import torch


def subsample_keep_probs(degrees: np.ndarray, sample: float) -> np.ndarray:
    """word2vec keep-probability per node (1.0 when sample <= 0):
    p_keep = min(1, sqrt(t/f) + t/f) with f the node's corpus frequency."""
    deg = np.asarray(degrees, np.float64)
    total = deg.sum()
    if sample <= 0 or total == 0:
        return np.ones(len(deg), np.float32)
    f = deg / total
    with np.errstate(divide="ignore", invalid="ignore"):
        p = np.sqrt(sample / f) + sample / f
    p = np.where(f > 0, np.minimum(p, 1.0), 1.0)
    return p.astype(np.float32)


def skipgram_pairs(
    walks: torch.Tensor,
    window: int,
    generator: torch.Generator | None = None,
    keep_probs: torch.Tensor | None = None,
    *,
    b: torch.Tensor | None = None,
    u: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Expand walks into (center, context, mask) pair tensors.

    Args:
      walks: int [B, L] node ids.
      window: max window W.
      generator: draws ``b`` and ``u`` when they are not given (on the
        walks' device).
      keep_probs: optional f32 [V] per-node keep probability.
      b: optional int [B, L] (or [B, L, 1]) reduced-window draws in 0..W-1.
      u: optional f32 [B, L] keep uniforms (used only with ``keep_probs``).

    Returns centers int [B, L, 2W], contexts int [B, L, 2W] (0 where the
    offset leaves the walk), mask bool [B, L, 2W].
    """
    B, L = walks.shape
    W = int(window)
    dev = walks.device
    off = torch.tensor([o for o in range(-W, W + 1) if o != 0], device=dev)
    at = torch.arange(L, device=dev)[:, None] + off[None, :]  # [L, 2W]
    in_range = (at >= 0) & (at < L)
    at = at.clamp(0, L - 1)
    contexts = torch.where(in_range, walks[:, at], 0)
    if b is None:
        b = torch.randint(0, W, (B, L), generator=generator, device=dev)
    in_window = off.abs() <= (W - b.reshape(B, L, 1))
    mask = in_range & in_window
    centers = walks[:, :, None].expand(B, L, 2 * W)
    if keep_probs is not None:
        if u is None:
            u = torch.rand((B, L), generator=generator, device=dev)
        kept = u < keep_probs[walks.long()]
        kept_ctx = in_range & kept[:, at]
        mask = mask & kept[:, :, None] & kept_ctx
    return centers, contexts, mask
