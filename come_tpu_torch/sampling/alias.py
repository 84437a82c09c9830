"""Negative sampling via Walker's alias method.

Port of ``come_tpu/sampling/alias.py``: the alias arrays are built once on
the host in numpy (identical output to the JAX package), and draws run on
the device with two gathers and one select per draw.
"""

from __future__ import annotations

import numpy as np
import torch


def unigram_weights(degrees: np.ndarray, power: float = 0.75) -> np.ndarray:
    """The reference's noise distribution: degree^0.75 (word2vec unigram)."""
    w = np.asarray(degrees, np.float64) ** power
    s = w.sum()
    if s <= 0:
        return np.full(len(w), 1.0 / max(len(w), 1))
    return w / s


def build_alias_table(probs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Walker '74 / Vose alias construction. Host-side, O(V).

    Returns (accept f32 [V], alias int32 [V]): draw u ~ U{0..V-1},
    v ~ U[0,1); the sample is ``u if v < accept[u] else alias[u]``.
    """
    probs = np.asarray(probs, np.float64)
    n = len(probs)
    scaled = probs * n / probs.sum()
    accept = np.zeros(n, np.float32)
    alias = np.zeros(n, np.int32)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        accept[s] = scaled[s]
        alias[s] = l
        scaled[l] = scaled[l] - (1.0 - scaled[s])
        (small if scaled[l] < 1.0 else large).append(l)
    for i in large + small:
        accept[i] = 1.0
        alias[i] = i
    return accept, alias


def sample_alias(
    accept: torch.Tensor,
    alias: torch.Tensor,
    generator: torch.Generator,
    shape: tuple[int, ...],
) -> torch.Tensor:
    """Draw int32 samples of ``shape`` on ``accept``'s device.

    ``generator`` must live on that device."""
    n = accept.shape[0]
    dev = accept.device
    u = torch.randint(0, n, shape, generator=generator, device=dev)
    v = torch.rand(shape, generator=generator, device=dev)
    return torch.where(v < accept[u], u, alias[u].long()).to(torch.int32)
