from come_tpu_torch.evaluation.metrics import (
    f1_train_ratio_sweep,
    node_classification_f1,
    nmi_score,
)

__all__ = ["nmi_score", "node_classification_f1", "f1_train_ratio_sweep"]
