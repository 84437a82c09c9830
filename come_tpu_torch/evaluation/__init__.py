from come_tpu_torch.evaluation.metrics import nmi_score

__all__ = ["nmi_score"]
