from come_tpu_torch.losses.community import (
    community_grad,
    community_loss,
    community_sgd_step,
)
from come_tpu_torch.losses.gmm import fit_communities, gmm_em_fit
from come_tpu_torch.losses.sgns import sgns_sgd_step
from come_tpu_torch.losses.sgns_block import sgns_block_grads_from_rows

__all__ = [
    "community_grad",
    "community_loss",
    "community_sgd_step",
    "fit_communities",
    "gmm_em_fit",
    "sgns_block_grads_from_rows",
    "sgns_sgd_step",
]
