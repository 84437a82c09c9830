from come_tpu_torch.config.presets import PRESETS, ComEConfig, get_config

__all__ = ["ComEConfig", "PRESETS", "get_config"]
