"""O3 — GMM community-closure loss and its SGD step.

Port of ``come_tpu/losses/community.py`` (full-table form).  With
responsibilities pi and covariances held fixed between EM fits, the trained
objective for node i is

    L3_i = beta/K * sum_k pi_ik * [ -log N(phi_i ; psi_k, Sigma_k) ]

whose phi-gradient is

    dL3/dphi_i = beta/K * sum_k pi_ik * Sigma_k^{-1} (phi_i - psi_k)

Both functions build their [N, K, d] temporaries over ``ROW_CHUNK`` nodes
at a time (16.4 GB whole at N = 500 000, K = 64), so only the order of the
loss's f32 sum over nodes differs from the unchunked form.
"""

from __future__ import annotations

import torch

from come_tpu_torch.losses.gmm import ROW_CHUNK

_LOG_2PI = 1.8378770664093453


def community_grad(node_emb, pi, centroid, inv_cov, beta: float):
    """dL3/dphi for every node: [N, d]."""
    K = centroid.shape[0]
    out = torch.empty_like(node_emb)
    for s in range(0, node_emb.shape[0], ROW_CHUNK):
        e = s + ROW_CHUNK
        diff = node_emb[s:e, None, :] - centroid[None]  # [n, K, d]
        mv = torch.einsum("nkd,kde->nke", diff, inv_cov)  # Sigma^-1 (phi-psi)
        out[s:e] = (beta / K) * torch.einsum("nk,nke->ne", pi[s:e], mv)
    return out


def community_loss(node_emb, pi, centroid, chol_cov, inv_cov, beta: float):
    """Monitored O3 value: responsibility-weighted negative log-pdf."""
    K, d = centroid.shape
    logdet = 2.0 * torch.log(
        torch.diagonal(chol_cov, dim1=-2, dim2=-1)
    ).sum(-1)  # [K]
    total = 0.0
    for s in range(0, node_emb.shape[0], ROW_CHUNK):
        e = s + ROW_CHUNK
        diff = node_emb[s:e, None, :] - centroid[None]  # [n, K, d]
        quad = torch.einsum(
            "nke,nke->nk", torch.einsum("nkd,kde->nke", diff, inv_cov), diff
        )
        neg_logpdf = 0.5 * (d * _LOG_2PI + logdet[None, :] + quad)
        total = total + (pi[s:e] * neg_logpdf).sum()
    return (beta / K) * total


def community_sgd_step(node_emb, pi, centroid, inv_cov, beta: float, lr,
                       grad_clip: float | None = None):
    """Returns ``node_emb - lr * dL3/dphi`` (a new tensor).

    ``grad_clip`` bounds each node's gradient L2 norm, preserving its
    direction (guards a near-singular EM fit)."""
    g = community_grad(node_emb, pi, centroid, inv_cov, beta)
    if grad_clip is not None:
        norm = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
        g = g * torch.clamp(grad_clip / norm.clamp_min(1e-12), max=1.0)
    return node_emb - lr * g
