"""O1 epochs of the blogcatalog preset fed by the device walker and by the
host walker (``corpus="host"``) at several walker thread counts, on one
card, in turns.

    python -m come_tpu_torch.tools.host_feed [--epochs 2] [--threads 1 7 8]

Each run builds a fresh trainer, trains one O1 epoch to warm up and then
``--epochs`` timed ones (host clock between ``torch.cuda.synchronize()``
calls), and prints one JSON line: the card and its power limit, the
corpus, the walker's threads, ms per epoch, and the feeder's queue wait and
walker time over the timed epochs.  The runs go in the order device, each
thread count, then the same backwards, so drift shows as a difference
between a setting's two runs.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch


def run_one(ds, corpus: str, threads: int | None, epochs: int, smi: str):
    from come_tpu_torch.config import get_config
    from come_tpu_torch.native import walker
    from come_tpu_torch.trainer import ComETrainer

    cfg = get_config("blogcatalog").replace(
        num_communities=ds.num_communities, corpus=corpus,
        pretrain_epochs=epochs + 1, outer_iters=0,
    )
    default = walker.default_threads
    if threads is not None:
        walker.default_threads = lambda: threads
    t = ComETrainer(ds.graph, cfg, "cuda")
    try:
        t.o1_epoch()
        f = t._host_feeder
        wait0, prod0 = (f.wait_s, f.produce_s) if f else (0.0, 0.0)
        ms = []
        for _ in range(epochs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.o1_epoch()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        rec = {"card": smi, "corpus": corpus, "threads": threads,
               "o1_epoch_ms": ms}
        if f:
            rec["queue_wait_ms"] = (f.wait_s - wait0) * 1e3
            rec["walker_ms"] = (f.produce_s - prod0) * 1e3
        return rec
    finally:
        t.close()
        walker.default_threads = default


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--threads", type=int, nargs="+", default=[1, 7, 8])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("host_feed: needs a CUDA card")
    from come_tpu_torch.graphs import get_dataset

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    ds = get_dataset("blogcatalog")
    order = [("device", None)] + [("host", n) for n in args.threads]
    for corpus, threads in order + order[::-1]:
        print(json.dumps(run_one(ds, corpus, threads, args.epochs, smi)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
