from come_tpu_torch.ops.star_sgns import star_sgns_step
from come_tpu_torch.ops.walk_sgns import walk_sgns_step

__all__ = ["star_sgns_step", "walk_sgns_step"]
