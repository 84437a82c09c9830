"""Dataset registry.

Port of ``come_tpu/graphs/datasets.py``: Karate from its adjacency list in
``data/Karate/``; BlogCatalog, Wikipedia, Flickr and DBLP from their
``.mat`` files when those are present under ``data/``, else from the
offline SBM stand-in at the published node/community counts; and the
synthetic-10m stand-in (BASELINE config 5).  The same sizes and seeds as the
JAX package, so both train on the identical graph.
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path

import numpy as np

from come_tpu_torch.graphs.csr import CSRGraph
from come_tpu_torch.graphs.generators import sbm_graph
from come_tpu_torch.graphs.loaders import (
    load_adjacencylist,
    load_ground_truth,
    load_mat_labels,
    load_matfile,
)

DATA_ROOT = Path(__file__).resolve().parents[2] / "data"


@dataclasses.dataclass(frozen=True)
class Dataset:
    name: str
    graph: CSRGraph
    labels: np.ndarray | None  # [V] int single-label, or [V, C] 0/1 multi-label
    num_communities: int

    @property
    def single_labels(self) -> np.ndarray | None:
        """Single community id per node (argmax for multi-label)."""
        if self.labels is None:
            return None
        if self.labels.ndim == 2:
            return np.argmax(self.labels, axis=1).astype(np.int32)
        return self.labels


# Published node/community counts (SURVEY.md C13) and the stand-ins' SBM
# calibration, as in come_tpu/graphs/datasets.py.
_MAT_SPECS = {
    "blogcatalog": dict(nodes=10312, communities=39, avg_degree=64.8,
                        p_out=0.005),
    "wikipedia": dict(nodes=4777, communities=40, avg_degree=38.7,
                      p_out=0.005),
    "flickr": dict(nodes=80513, communities=195, avg_degree=146.6,
                   p_out=0.0005),
    "dblp": dict(nodes=13184, communities=5, avg_degree=7.2,
                 p_out=0.005),
}


def _load_karate() -> Dataset:
    g = load_adjacencylist(DATA_ROOT / "Karate" / "karate.adjlist")
    labels = load_ground_truth(DATA_ROOT / "Karate" / "karate_labels.txt")
    return Dataset("karate", g, labels, num_communities=2)


def _load_mat_or_synthetic(name: str, seed: int = 0) -> Dataset:
    spec = _MAT_SPECS[name]
    for cand in (
        DATA_ROOT / name.capitalize() / f"{name}.mat",
        DATA_ROOT / name.capitalize() / f"{name.capitalize()}.mat",
        DATA_ROOT / name / f"{name}.mat",
    ):
        if cand.exists():
            labels = load_mat_labels(cand)
            return Dataset(name, load_matfile(cand), labels,
                           num_communities=labels.shape[1])
    g, labels = sbm_graph(
        spec["nodes"],
        spec["communities"],
        seed=seed,
        avg_degree=spec["avg_degree"],
        p_in=0.1,
        p_out=spec["p_out"],
    )
    return Dataset(f"{name}-synthetic", g, labels, spec["communities"])


@functools.cache
def _load_synthetic_10m(seed: int = 0) -> Dataset:
    """BASELINE config 5: V = 500 000, 64 communities, ~10M edges
    (``come_tpu/graphs/datasets.py:96-101``).  Built once per process: the
    SBM takes seconds to a minute of host time, and nothing writes to a
    Dataset's arrays."""
    g, labels = sbm_graph(
        500_000, 64, seed=seed, avg_degree=40.0, p_in=0.1, p_out=0.002
    )
    return Dataset("synthetic-10m", g, labels, 64)


DATASETS = ["karate", *sorted(_MAT_SPECS), "synthetic-10m"]


def get_dataset(name: str) -> Dataset:
    key = name.lower().replace("-synthetic", "")
    if key == "synthetic-10m":
        return _load_synthetic_10m()
    if key == "karate":
        return _load_karate()
    if key not in _MAT_SPECS:
        raise KeyError(f"unknown dataset {name!r}; have {DATASETS}")
    return _load_mat_or_synthetic(key)
