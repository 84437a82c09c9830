"""Block SGNS with one shared pool of negatives: the tile math.

Port of ``come_tpu/losses/sgns_block.py::sgns_block_grads_from_rows``.
Every valid pair of a block scores all K' rows of a shared negative pool,
each with weight ``negative_weight`` (= k / K', so one trained pair still
means one positive and k noise comparisons in expectation), which turns the
negative term into three dense products:

  scores  S = Phi @ Cneg^T               [B, K']
  d_Phi  += (sigma(S) * w) @ Cneg        [B, d]
  d_Cneg  = (sigma(S) * w)^T @ Phi       [K', d]

It is the building block of the plain versions of the K6/K7 kernels
(``ops/sgns.py``).  The JAX package's whole-micro-step block path
(``sgns_block_sgd_step``) is an XLA tier that the port replaces with K6/K7
(ROADMAP decision 1), so it is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from come_tpu_torch.ops.sparse import sddmm_pair_scores


def sgns_block_grads_from_rows(phi, cpos, cneg, mask, negative_weight: float):
    """phi, cpos [B, d], cneg [K', d], mask [B].

    Returns (loss, n_pairs, (d_phi [B, d], d_cpos [B, d], d_cneg [K', d])).
    """
    m = mask.to(phi.dtype)
    spos = sddmm_pair_scores(phi, cpos)  # [B]
    sneg = phi @ cneg.T  # [B, K']
    loss = -((m * F.logsigmoid(spos)).sum()
             + negative_weight * (m[:, None] * F.logsigmoid(-sneg)).sum())
    gpos = (torch.sigmoid(spos) - 1.0) * m
    gneg = torch.sigmoid(sneg) * (negative_weight * m[:, None])
    d_phi = gpos[:, None] * cpos + gneg @ cneg
    d_cpos = gpos[:, None] * phi
    d_cneg = gneg.T @ phi
    return loss, m.sum(), (d_phi, d_cpos, d_cneg)
