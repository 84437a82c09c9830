"""Dataset registry: the offline SBM stand-ins at published scale.

Port of ``come_tpu/graphs/datasets.py`` for the synthetic stand-ins
(blogcatalog, wikipedia, dblp, flickr), with the same sizes and seeds, so
both packages train on the identical graph.  Karate's adjacency list and the
``.mat`` files wait for the loaders item of ROADMAP Queue 1.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from come_tpu_torch.graphs.csr import CSRGraph
from come_tpu_torch.graphs.generators import sbm_graph


@dataclasses.dataclass(frozen=True)
class Dataset:
    name: str
    graph: CSRGraph
    labels: np.ndarray  # [V] int, one community per node
    num_communities: int


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

_NOT_YET = {
    "karate": "karate adjacency-list loading",
    "synthetic-10m": "the synthetic-10m stand-in",
}


def _synthetic(name: str, seed: int = 0) -> Dataset:
    spec = _MAT_SPECS[name]
    g, labels = sbm_graph(
        spec["nodes"],
        spec["communities"],
        seed=seed,
        avg_degree=spec["avg_degree"],
        p_in=0.1,
        p_out=spec["p_out"],
    )
    return Dataset(f"{name}-synthetic", g, labels, spec["communities"])


DATASETS = sorted(_MAT_SPECS)


def get_dataset(name: str) -> Dataset:
    """The SBM stand-in of a registered dataset.  Real ``.mat`` files are
    not read yet: the port always trains on the stand-in."""
    key = name.lower().replace("-synthetic", "")
    if key in _NOT_YET:
        raise NotImplementedError(
            f"{_NOT_YET[key]} is not ported yet (ROADMAP Queue 1, "
            "'Loaders and .mat datasets')"
        )
    if key not in _MAT_SPECS:
        raise KeyError(f"unknown dataset {name!r}; have {DATASETS}")
    return _synthetic(key)
