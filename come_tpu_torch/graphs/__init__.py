from come_tpu_torch.graphs.csr import CSRGraph, DeviceCSR
from come_tpu_torch.graphs.datasets import DATASETS, Dataset, get_dataset
from come_tpu_torch.graphs.generators import sbm_graph

__all__ = [
    "CSRGraph",
    "DeviceCSR",
    "DATASETS",
    "Dataset",
    "get_dataset",
    "sbm_graph",
]
