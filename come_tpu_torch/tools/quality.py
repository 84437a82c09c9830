"""Full-depth quality runs on one card: NMI and seconds per outer iteration.

    python -m come_tpu_torch.tools.quality [--runs blogcatalog bench-gen
        synthetic-10m micro] [--seed 0] [--dim D] [--root DIR]

Trains each named configuration at its preset's full schedule (pretrain 2
+ outer 5) through ``ComETrainer`` on the card and prints one JSON line per
run: the card's name and power limit, the width, the kernels that launched
(by mode; G1's factor and inverse too),
seconds per outer iteration (GMM + O1 + O2 + O3, each timed between device
synchronises by the trainer), O1 and O2 epoch ms and pairs per second, NMI
after every outer iteration, the wall seconds of the whole run (graph and
trainer set-up excluded) and the peak of ``torch.cuda.max_memory_allocated()``.

  * ``blogcatalog``: the preset (K1 for O1, K2 for O2);
  * ``bench-gen``: the reference bench's kernel configuration with walks made
    in the kernel (``bench.py:207-216``: bf16 products, R 8, 2048-walk steps,
    ``batch_edges`` 524288; K4 in its bf16 mode and K2b);
  * ``synthetic-10m``: the large-V preset (K3 on bf16 tables, K2);
  * ``micro``: the blogcatalog preset on the micro-batched tier
    (``--down-sample 1e-3 --o2-mode xla``: K6 for O1, K7 for O2).

``--dim`` trains every run at that width instead of the preset's (past 192
K1, K5 and K2 run their column-slab band and star passes and the wide
negative pass, past 128 G1 its device-memory kernels).  ``--root`` trains with the ``come_tpu_torch`` package of another
checkout (run the file by its path, not with ``-m``), so two trees compare
on one card in one call.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

RUNS = ("blogcatalog", "bench-gen", "synthetic-10m", "micro")


def _config(name: str, ds, seed: int):
    from come_tpu_torch.config import get_config

    if name == "bench-gen":
        return get_config("blogcatalog").replace(
            num_communities=ds.num_communities, walk_kernel_bf16=True,
            walk_pool_refresh=8, batch_walks=2048, batch_edges=524288,
            walk_gen="kernel", seed=seed)
    if name == "micro":
        return get_config("blogcatalog").replace(
            num_communities=ds.num_communities, down_sample=1e-3,
            o2_mode="xla", seed=seed)
    return get_config(name).replace(num_communities=ds.num_communities,
                                    seed=seed)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--runs", nargs="+", default=list(RUNS), choices=RUNS)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dim", type=int, default=None,
                   help="the embedding width (default: the preset's)")
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                   help="the checkout whose come_tpu_torch to train with")
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    if not torch.cuda.is_available():
        raise SystemExit("quality: needs a CUDA card")

    import come_tpu_torch
    from come_tpu_torch.graphs import get_dataset
    from come_tpu_torch.ops.gmm_factor import gmm_factor, gmm_inverse
    from come_tpu_torch.tools.eval_sweep import card_name, launch_counts
    from come_tpu_torch.trainer import ComETrainer

    card = card_name()
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    for name in args.runs:
        ds = get_dataset("synthetic-10m" if name == "synthetic-10m"
                         else "blogcatalog")
        cfg = _config(name, ds, args.seed)
        if args.dim is not None:
            cfg = cfg.replace(dim=args.dim)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        trainer = ComETrainer(ds.graph, cfg, dev)
        before = launch_counts()
        g1 = gmm_factor.launches, gmm_inverse.launches
        t0 = time.perf_counter()
        hist = trainer.train(ds.single_labels)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launched = {k: v - before[k] for k, v in launch_counts().items()
                    if v != before[k]}
        launched["gmm_factor"] = gmm_factor.launches - g1[0]
        launched["gmm_inverse"] = gmm_inverse.launches - g1[1]
        s_iter = [sum(r[f"{k}_ms"] for k in ("gmm", "o1", "o2", "o3")) / 1e3
                  for r in hist]
        rec = hist[-1]
        print(json.dumps({
            "card": card, "package": str(Path(come_tpu_torch.__file__).parent),
            "run": name, "dim": cfg.dim, "pretrain": cfg.pretrain_epochs,
            "outer": cfg.outer_iters, "walks_per_node": cfg.walks_per_node,
            "launches": launched, "s_per_iter": s_iter,
            "o1_ms": [r["o1_ms"] for r in hist],
            "o2_ms": [r["o2_ms"] for r in hist],
            "o1_pairs_per_s": rec["o1_pairs"] / rec["o1_ms"] * 1e3,
            "o2_pairs_per_s": rec["o2_pairs"] / rec["o2_ms"] * 1e3,
            "nmi_per_iter": [r["nmi"] for r in hist], "nmi": rec["nmi"],
            "wall_s": wall,
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        }), flush=True)
        del trainer
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
