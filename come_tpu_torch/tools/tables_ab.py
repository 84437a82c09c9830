"""The O1 table-dtype A/B on the large-V path, in one process on one card.

    python -m come_tpu_torch.tools.tables_ab [--walks-per-node 1]
        [--pretrain-epochs 1] [--outer-iters 1] [--order bf16 f32]
        [--profile]

Trains the synthetic-10m preset (V 500 000, d 128, K 64, KP 2048) through
``ComETrainer`` on the card once per entry of ``--order``: ``bf16`` is the
preset (bf16 working tables for O1, K3) and ``f32`` sets
``walk_kernel_bf16_tables=False`` (f32 tables, K1); the same seed both ways.
The default depth is chip_smoke's (walks per node 1, pretrain 1, outer 1).
Prints one line per run: the card's name and power limit, per-phase ms of
the last outer iteration, O1 and O2 pairs per second, NMI and the peak of
``torch.cuda.max_memory_allocated()``.  With ``--profile``, each trained
run then traces two O1 macro steps and one O2 macro step under
``torch.profiler`` and prints the device time by kernel and the card's busy
share of that window.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--walks-per-node", type=int, default=1)
    p.add_argument("--pretrain-epochs", type=int, default=1)
    p.add_argument("--outer-iters", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--order", nargs="+", default=["bf16", "f32"],
                   choices=["bf16", "f32"])
    p.add_argument("--profile", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tables_ab: needs a CUDA card")

    from come_tpu_torch.config import get_config
    from come_tpu_torch.graphs import get_dataset
    from come_tpu_torch.trainer import ComETrainer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)  # the allocator's stats exist from here
    ds = get_dataset("synthetic-10m")
    for tables in args.order:
        cfg = get_config("synthetic-10m").replace(
            num_communities=ds.num_communities,
            walks_per_node=args.walks_per_node,
            pretrain_epochs=args.pretrain_epochs,
            outer_iters=args.outer_iters, seed=args.seed,
            walk_kernel_bf16_tables=tables == "bf16",
        )
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        trainer = ComETrainer(ds.graph, cfg, dev)
        hist = trainer.train(ds.single_labels)
        torch.cuda.synchronize(dev)
        rec = hist[-1]
        print(json.dumps({
            "card": card, "tables": tables,
            "o1_table_dtype": str(trainer.o1_table_dtype),
            "wall_s": time.perf_counter() - t0,
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            "o1_pairs_per_s": rec["o1_pairs"] / rec["o1_ms"] * 1e3,
            "o2_pairs_per_s": rec["o2_pairs"] / rec["o2_ms"] * 1e3,
            "nmi_per_iter": [r["nmi"] for r in hist],
            **{k: rec[k] for k in ("gmm_ms", "o1_ms", "o2_ms", "o3_ms",
                                   "o1_pairs", "o2_pairs", "nmi")},
        }), flush=True)
        if args.profile:
            profile_steps(trainer, tables)
        del trainer
    return 0


def profile_steps(trainer, tables: str) -> None:
    """Trace two O1 macro steps and one O2 macro step of a trained
    ``trainer``; print one JSON line of device ms by kernel (per step
    kind) and the busy share of each traced window."""
    from torch.profiler import ProfilerActivity, profile

    from come_tpu_torch.sampling import sample_alias

    def trace(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kern = {e.key: round(e.device_time_total / 1e3, 3)
                for e in prof.key_averages() if e.device_time_total > 0}
        busy = sum(kern.values()) * 1e3 / wall_us
        top = dict(sorted(kern.items(), key=lambda kv: -kv[1])[:8])
        return {"wall_ms": wall_us / 1e3, "busy": busy, "kernel_ms": top}

    def o1():
        with trainer._o1_tables():
            for st in trainer._epoch_starts()[:2]:
                walks = trainer._gen_epoch_walks(st[None])[0]
                trainer.o1_step(walks, *trainer._o1_draws(walks.shape[0]))

    def o2():
        rps, _ = trainer.o2_plan()
        NR = trainer._star_layout()[0].shape[0]
        ps, pm = trainer.o2_stream(torch.randperm(NR, device=trainer.device))
        pools = sample_alias(trainer.accept, trainer.alias, trainer.gen,
                             (rps * 128 // 1024, trainer.cfg.shared_negatives))
        trainer.o2_step(ps[:rps].reshape(-1), pm[:rps].reshape(-1), pools,
                        0.0)

    print(json.dumps({"tables": tables, "profile_o1_2_steps": trace(o1),
                      "profile_o2_1_step": trace(o2)}), flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
