"""Skip-gram negative sampling with per-pair negatives (O1 and O2).

Port of ``come_tpu/losses/sgns.py`` as torch ops: the loss over a masked
batch of (center, context, K negatives) triples with hand-written
gradients, applied by a duplicate-summing scatter-add.  The JAX package runs
this outside any Pallas kernel; so does the port.

Loss (descent convention):
    L = -sum_p m_p [ log s(phi_p . c_p) + sum_k log s(-phi_p . n_pk) ]

``max_exp`` emulates the reference's EXP_TABLE clamp: a positive or
negative term whose score magnitude reaches ``max_exp`` is skipped
entirely.  ``None`` trains every term exactly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from come_tpu_torch.ops.sparse import (
    gather_rows,
    scatter_add_rows_,
    sddmm_neg_scores,
    sddmm_pair_scores,
)


def sgns_grads_from_rows(phi, cpos, cneg, mask, max_exp: float | None = None):
    """SGNS math on gathered rows: phi, cpos [P, d], cneg [P, K, d],
    mask bool/float [P].  Returns (loss, n_pairs, (d_phi [P, d],
    d_cpos [P, d], d_cneg [P, K, d]))."""
    spos = sddmm_pair_scores(phi, cpos)  # [P]
    sneg = sddmm_neg_scores(phi, cneg)  # [P, K]
    m = mask.to(phi.dtype)
    mpos = m
    mneg = m[:, None].expand_as(sneg)
    if max_exp is not None:
        mpos = mpos * (spos.abs() < max_exp)
        mneg = mneg * (sneg.abs() < max_exp)
    loss = -((mpos * F.logsigmoid(spos)).sum()
             + (mneg * F.logsigmoid(-sneg)).sum())
    gpos = (torch.sigmoid(spos) - 1.0) * mpos  # dL/dspos
    gneg = torch.sigmoid(sneg) * mneg  # dL/dsneg
    d_phi = gpos[:, None] * cpos + torch.einsum("pk,pkd->pd", gneg, cneg)
    d_cpos = gpos[:, None] * phi
    d_cneg = gneg[..., None] * phi[:, None, :]
    return loss, m.sum(), (d_phi, d_cpos, d_cneg)


def sgns_loss_and_grads(emb_in, emb_out, centers, contexts, negatives, mask,
                        max_exp: float | None = None):
    """Loss and per-row gradient contributions for one batch: centers,
    contexts int [P], negatives int [P, K].  See
    :func:`sgns_grads_from_rows`."""
    phi = gather_rows(emb_in, centers)
    cpos = gather_rows(emb_out, contexts)
    cneg = gather_rows(emb_out, negatives)
    return sgns_grads_from_rows(phi, cpos, cneg, mask, max_exp)


def sgns_sgd_step(emb_in, emb_out, centers, contexts, negatives, mask, lr,
                  tie_tables: bool = False, max_exp: float | None = None):
    """One synchronous minibatch SGD step: tables -= lr * dL/dtable.

    Every gradient is taken from the tables as they are on entry; the
    tables are then updated IN PLACE and returned.  ``tie_tables=True`` is
    the O2 mode: endpoints and negatives live in one table (pass it as both
    ``emb_in`` and ``emb_out``) and all updates go through one scatter.

    Returns (emb_in, emb_out, loss, n_pairs).
    """
    loss, n_pairs, (d_phi, d_cpos, d_cneg) = sgns_loss_and_grads(
        emb_in, emb_out, centers, contexts, negatives, mask, max_exp
    )
    neg_idx = negatives.reshape(-1)
    d_cneg = d_cneg.reshape(-1, emb_in.shape[1])
    if tie_tables:
        scatter_add_rows_(emb_in, torch.cat([centers, contexts, neg_idx]),
                          torch.cat([d_phi, d_cpos, d_cneg]), -lr)
        return emb_in, emb_in, loss, n_pairs
    scatter_add_rows_(emb_in, centers, d_phi, -lr)
    scatter_add_rows_(emb_out, torch.cat([contexts, neg_idx]),
                      torch.cat([d_cpos, d_cneg]), -lr)
    return emb_in, emb_out, loss, n_pairs
