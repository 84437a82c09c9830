"""ComE model state: embedding tables and community parameters.

Port of ``come_tpu/models/state.py``.  The JAX package threads an immutable
pytree through pure steps; here the state is one ``nn.Module`` whose tensors
are buffers (ComE trains by hand-written SGD, not autograd) and the steps
update them in place.

Shapes (V nodes, d dims, K communities):
  node_emb [V, d]   - the phi table, init U[-0.5/d, 0.5/d] (reference init)
  ctx_emb  [V, d]   - the context/output table, zero init (word2vec style)
  centroid [K, d]   - GMM means psi_k
  chol_cov [K, d, d]- lower-Cholesky factors of the GMM covariances
  inv_cov  [K, d, d]- covariance inverses (used by the O3 gradient)
  pi       [V, K]   - community responsibilities (E-step output)
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

FIELDS = ("node_emb", "ctx_emb", "centroid", "chol_cov", "inv_cov", "pi")


class ComEParams(nn.Module):
    """The six ComE tensors as buffers, named as the JAX ``ComEParams``."""

    node_emb: torch.Tensor
    ctx_emb: torch.Tensor
    centroid: torch.Tensor
    chol_cov: torch.Tensor
    inv_cov: torch.Tensor
    pi: torch.Tensor

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        if set(tensors) != set(FIELDS):
            raise ValueError(f"need exactly the fields {FIELDS}")
        for k in FIELDS:
            self.register_buffer(k, tensors[k])

    @property
    def num_nodes(self) -> int:
        return self.node_emb.shape[0]

    @property
    def dim(self) -> int:
        return self.node_emb.shape[1]

    @property
    def num_communities(self) -> int:
        return self.centroid.shape[0]

    def to_numpy(self) -> dict[str, np.ndarray]:
        """Host copies keyed by the JAX field names."""
        return {k: getattr(self, k).detach().cpu().numpy() for k in FIELDS}


def from_numpy(d: dict, device) -> ComEParams:
    """Params holding the values of ``d`` (numpy arrays keyed by the JAX
    ``ComEParams`` field names), as f32 tensors on ``device``."""
    return ComEParams(**{
        k: torch.tensor(np.asarray(d[k], np.float32), device=device)
        for k in FIELDS
    })


def init_params(
    num_nodes: int,
    dim: int,
    num_communities: int,
    generator: torch.Generator,
    device,
) -> ComEParams:
    """Reference-matching init: node_emb ~ U[-0.5/d, 0.5/d], ctx_emb = 0.

    Community params start at the standard-normal GMM (identity covariances,
    uniform responsibilities); the first GMM fit overwrites them.
    ``generator`` must live on ``device``."""
    v, d, k = num_nodes, dim, num_communities
    f32 = torch.float32
    node = torch.rand((v, d), generator=generator, device=device, dtype=f32)
    node = node * (1.0 / d) - 0.5 / d
    eye = torch.eye(d, dtype=f32, device=device)
    return ComEParams(
        node_emb=node,
        ctx_emb=torch.zeros((v, d), dtype=f32, device=device),
        centroid=torch.zeros((k, d), dtype=f32, device=device),
        chol_cov=eye.expand(k, d, d).clone(),
        inv_cov=eye.expand(k, d, d).clone(),
        pi=torch.full((v, k), 1.0 / k, dtype=f32, device=device),
    )
