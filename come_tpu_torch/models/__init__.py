from come_tpu_torch.models.state import ComEParams, from_numpy, init_params

__all__ = ["ComEParams", "from_numpy", "init_params"]
