from come_tpu_torch.trainer.come import ComETrainer

__all__ = ["ComETrainer"]
