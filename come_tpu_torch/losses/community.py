"""O3 — GMM community-closure loss and its SGD step.

Port of ``come_tpu/losses/community.py`` (full-table form).  With
responsibilities pi and covariances held fixed between EM fits, the trained
objective for node i is

    L3_i = beta/K * sum_k pi_ik * [ -log N(phi_i ; psi_k, Sigma_k) ]

whose phi-gradient is

    dL3/dphi_i = beta/K * sum_k pi_ik * Sigma_k^{-1} (phi_i - psi_k)
"""

from __future__ import annotations

import torch

_LOG_2PI = 1.8378770664093453


def community_grad(node_emb, pi, centroid, inv_cov, beta: float):
    """dL3/dphi for every node: [N, d]."""
    K = centroid.shape[0]
    diff = node_emb[:, None, :] - centroid[None]  # [N, K, d]
    mv = torch.einsum("nkd,kde->nke", diff, inv_cov)  # Sigma^-1 (phi-psi)
    return (beta / K) * torch.einsum("nk,nke->ne", pi, mv)


def community_loss(node_emb, pi, centroid, chol_cov, inv_cov, beta: float):
    """Monitored O3 value: responsibility-weighted negative log-pdf."""
    K, d = centroid.shape
    diff = node_emb[:, None, :] - centroid[None]  # [N, K, d]
    quad = torch.einsum(
        "nke,nke->nk", torch.einsum("nkd,kde->nke", diff, inv_cov), diff
    )
    logdet = 2.0 * torch.log(
        torch.diagonal(chol_cov, dim1=-2, dim2=-1)
    ).sum(-1)  # [K]
    neg_logpdf = 0.5 * (d * _LOG_2PI + logdet[None, :] + quad)
    return (beta / K) * (pi * neg_logpdf).sum()


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
