from come_tpu_torch.graphs.csr import CSRGraph, DeviceCSR
from come_tpu_torch.graphs.datasets import DATASETS, Dataset, get_dataset
from come_tpu_torch.graphs.generators import (
    dc_sbm_graph,
    powerlaw_graph,
    sbm_graph,
)
from come_tpu_torch.graphs.loaders import (
    load_adjacencylist,
    load_edgelist,
    load_matfile,
)

__all__ = [
    "CSRGraph",
    "DeviceCSR",
    "DATASETS",
    "Dataset",
    "dc_sbm_graph",
    "get_dataset",
    "load_adjacencylist",
    "load_edgelist",
    "load_matfile",
    "powerlaw_graph",
    "sbm_graph",
]
