from come_tpu_torch.losses.community import (
    community_grad,
    community_loss,
    community_sgd_step,
)
from come_tpu_torch.losses.gmm import fit_communities, gmm_em_fit

__all__ = [
    "community_grad",
    "community_loss",
    "community_sgd_step",
    "fit_communities",
    "gmm_em_fit",
]
