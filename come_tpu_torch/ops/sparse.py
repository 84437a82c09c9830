"""Sparse embedding primitives: row gather, pair and negative scores, and a
duplicate-summing scatter-add.

Port of ``come_tpu/ops/sparse.py`` as torch ops.  The batch of pairs becomes
dense [P, d] tensors: gather rows, score every pair at once, and add the
updates back with ``index_add_``, where duplicate rows sum (in another order
than XLA's scatter, so the last bits may differ).  The JAX
``scatter_add_rows`` returns a new table; the port's ``scatter_add_rows_``
updates the table in place, as the port's kernels do, so an SGD step holds
no second [V, d] copy.  ``scatter_add_rows_sorted`` serves only the banded
tiers, which the port does not have (ROADMAP decision 1).
"""

from __future__ import annotations

import torch


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [V, d], idx int [...] -> rows [..., d]."""
    return table[idx.long()]


def sddmm_pair_scores(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise dot products: a [P, d] x b [P, d] -> [P]."""
    return (a * b).sum(-1)


def sddmm_neg_scores(a: torch.Tensor, negs: torch.Tensor) -> torch.Tensor:
    """a [P, d] x negs [P, K, d] -> [P, K] scores against K negatives each."""
    return torch.einsum("pd,pkd->pk", a, negs)


def scatter_add_rows_(
    table: torch.Tensor, idx: torch.Tensor, updates: torch.Tensor,
    alpha: float = 1.0,
) -> torch.Tensor:
    """table [V, d] += alpha * updates [P, d] at rows idx [P], in place
    (duplicates sum); returns ``table``."""
    return table.index_add_(0, idx.long(), updates, alpha=alpha)
