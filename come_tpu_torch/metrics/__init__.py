from come_tpu_torch.metrics.meters import ScalarLog, ThroughputMeter

__all__ = ["ThroughputMeter", "ScalarLog"]
