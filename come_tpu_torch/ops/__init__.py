from come_tpu_torch.ops.row_probe import row_gather_probe, row_scatter_probe
from come_tpu_torch.ops.sgns import fused_sgns_step, fused_sgns_step_tied
from come_tpu_torch.ops.star_sgns import star_sgns_step
from come_tpu_torch.ops.walk_sgns import walk_sgns_gen_step, walk_sgns_step

__all__ = [
    "fused_sgns_step",
    "fused_sgns_step_tied",
    "row_gather_probe",
    "row_scatter_probe",
    "star_sgns_step",
    "walk_sgns_gen_step",
    "walk_sgns_step",
]
