"""The JAX package's NMI on the low-SNR dc-SBM, the reading that chooses the
row's assortativity in ``EVAL_gpu_r01.json``.

The graph is ``dc_sbm_graph(5000, 12, avg_degree=30, exponent=2.5,
assortativity=a, seed=11)`` (``scripts/eval_sweep.py:30-41`` with a lower
``a``); the run is ``scripts/eval_sweep.py::run_one``'s single-device path
on the blogcatalog preset with 12 communities.  On the CPU the JAX trainer
takes its XLA tiers, not the Pallas walk kernel (``come_tpu/trainer/
come.py:248``: the kernel needs ``pallas="always"`` off a TPU).  The row
takes the first of 8, 5, 3 whose NMI lies in [0.4, 0.85].

    JAX_PLATFORMS=cpu python tests/_jax_low_snr.py 8 5 3

prints one JSON line per assortativity (NMI, macro/micro-F1, seconds), and
each epoch's progress on stderr.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SIZE = dict(avg_degree=30.0, exponent=2.5, seed=11)
CHOICES = (8.0, 5.0, 3.0)
BAND = (0.4, 0.85)


def run(a: float) -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from come_tpu.config import PRESETS
    from come_tpu.evaluation import node_classification_f1
    from come_tpu.graphs import dc_sbm_graph
    from come_tpu.trainer import ComETrainer

    g, labels = dc_sbm_graph(5000, 12, assortativity=a, **SIZE)
    cfg = PRESETS["blogcatalog"].replace(num_communities=12)
    t0 = time.time()
    tr = ComETrainer(g, cfg)
    hist = tr.train(labels=labels, log=lambda m: print(
        f"  a={a:g} {time.time() - t0:.0f} s: {m}", file=sys.stderr,
        flush=True))
    out = {"assortativity": a, "backend": jax.default_backend(),
           "nmi": hist[-1].get("nmi"),
           "seconds": round(time.time() - t0, 1)}
    out.update(node_classification_f1(tr.embeddings(), labels))
    return out


if __name__ == "__main__":
    for arg in sys.argv[1:] or [str(a) for a in CHOICES]:
        print(json.dumps(run(float(arg))), flush=True)
