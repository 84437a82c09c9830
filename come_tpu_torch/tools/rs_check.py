"""One rank of the row-sharded (model axis) check on the card.

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        -m come_tpu_torch.tools.rs_check --mesh D,M [--backend nccl|gloo] \\
        [--device cuda:0] [--synthetic] [--walks-per-node W] [--dim D] \\
        [--out DIR]

Each rank trains the blogcatalog preset at full width (V 10312, d 128 or
``--dim``, L 80, W 10, KP 512, R 1, 256-walk steps) through the CLI's entry
(``main.run`` with ``--mesh D,M``, pretrain 1 + outer 1), with the
kernels' launch counters set to 0 just before and read just after, then:

* times one more O1 epoch and one more O2 epoch, with CUDA events around
  every all-to-all and all-reduce (``parallel/collectives.py``'s meter):
  each epoch's ms, steps, the exchange's calls, bytes and ms and the
  all-reduce's, and the transport the group's backend chose;
* hashes the six parameter tensors of this rank (its model shard of the
  row tables, the replicated rest; ``dp_check.param_hash``) after the run
  and after those epochs, so the caller can hold each model shard
  bit-identical across 'data';
* holds one row-sharded K1 step and one K5 step at the main path's shapes
  (a data row's 256 // D walks sliced over 'model', its packed edge rows
  likewise, this worker's pools and window draws): the rows are planned
  and gathered through the exchange, the kernel runs on the compact
  tables and its plain version on clones of the same compact rows, and
  the updates are held to the f32 check, ``|upd - plain upd| <= 1e-6 +
  1e-4 |plain upd|`` (``tools/hot_row.py``'s rule, the plain step in
  float64, where it fails), loss within rtol 1e-4, pair counts exact;
  then both steps again, the same rows and draws, on shards 256 wide
  (``WIDE_D``) drawn from the rank's seed, where the kernels take their
  column-slab and wide passes;
* with ``--synthetic``, one more K1 step at the synthetic-10m shapes (V
  500 000 row-sharded over M, 1024 walks of 80 split over the workers,
  W 10, KP 2048, uniform ids): U compact rows per worker, held the same
  way, with its compact-table and exchange bytes and times.

It prints one JSON line per rank and writes it to ``DIR/rank<r>.json``; a
failed check raises, so the rank and the launcher exit non-zero.  Over
gloo the card's tensors are staged through the host: its times measure
correctness, not speed.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from pathlib import Path

import torch

from come_tpu_torch.ops import launch_plan
from come_tpu_torch.tools.dp_check import SEED, f32_ratio, param_hash

SYNTH = dict(V=500000, B=1024, KP=2048)
# the width of the held steps past MAX_DIM (csrc/sgns_common.cuh)
WIDE_D = 256


def _events_ms(fn, reps: int = 3) -> float:
    """Median CUDA-event ms of ``fn()`` over ``reps`` calls (host clock on
    the CPU)."""
    times = []
    for _ in range(reps):
        if torch.cuda.is_available():
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def held_step(t, tables, walks, wrow, pools, lr, negw, window, paired,
              name):
    """Plan and gather one step's compact rows of ``tables`` (this
    rank's shards), run the kernel on copies and the plain version on
    other copies, and check them.  Returns the check's numbers."""
    from come_tpu_torch.ops.walk_sgns import (
        walk_sgns_step,
        walk_sgns_step_reference,
    )
    from come_tpu_torch.parallel.collectives import METER
    from come_tpu_torch.parallel.walk_exchange import plan_walk_macro_steps

    cfg = t.cfg
    lay = t.layout
    b0 = METER.a2a_bytes
    plans, rw, rn, served = plan_walk_macro_steps(
        walks[None], pools[None], tables[0].shape[0],
        cfg.a2a_capacity_slack, lay.model_index, lay.model_size,
        t.model_group)
    plan = plans.step(0)
    rows = [plan.gather(x) for x in tables]
    if paired:
        rows = [rows[0], rows[0]]
    kw = dict(window=window, pool_refresh=cfg.walk_pool_refresh,
              paired=paired)
    rw, rn = rw[0], rn[0]

    def kernel():
        k = [r.clone() for r in rows]
        return k, walk_sgns_step(*k, rw, wrow, rn, lr, negw, **kw)[2:]

    def plain(acc=None):
        k = [r.clone() if acc is None else r.double() for r in rows]
        extra = {} if acc is None else {"acc": acc}
        return k, walk_sgns_step_reference(*k, rw, wrow, rn, lr, negw,
                                           **kw, **extra)[2:]

    got, (kl, kn) = kernel()
    want, (pl, pn) = plain()
    out = {"U": int(rows[0].shape[0]), "served": float(served[0]),
           "compact_bytes": sum(r.numel() * 4 for r in rows[:2 - paired]),
           "exchange_bytes": METER.a2a_bytes - b0}
    ratio = f32_ratio(rows, got, want)
    out["f32_ratio"] = ratio
    if ratio > 1.0:  # tools/hot_row.py's rule: the plain step in float64
        want64, _ = plain(torch.float64)
        ratio = f32_ratio(rows, got, want64)
        out["f64_ratio"] = ratio
    if ratio > 1.0:
        raise AssertionError(f"{name}: worst ratio {ratio:.3f} > 1")
    if abs(float(kl) - float(pl)) > 1e-4 * abs(float(pl)):
        raise AssertionError(f"{name}: loss {float(kl)} vs {float(pl)}")
    if float(kn) != float(pn):
        raise AssertionError(f"{name}: pairs {float(kn)} vs {float(pn)}")
    out["loss"], out["pairs"] = float(kl), float(kn)
    out["ms"] = _events_ms(kernel)
    out["plain_ms"] = _events_ms(plain, reps=1)
    return out


def held_steps(t) -> dict:
    """The held row-sharded K1 and K5 steps of this rank."""
    from come_tpu_torch.ops.walk_sgns import NWL
    from come_tpu_torch.sampling import random_walks, sample_alias

    cfg, dev, p, lay = t.cfg, t.device, t.params, t.layout
    D = lay.data_size
    di, rank = lay.data_index, lay.rank
    data = torch.Generator(device=dev).manual_seed(SEED + 1000 + di)
    mine = torch.Generator(device=dev).manual_seed(SEED + 2000 + rank)
    KP = cfg.shared_negatives
    out = {}
    # K1: the data row's walks, this worker's slice, pools and draws
    b_w, G, n_pools = t._rowsharded_walk_shapes()
    starts = torch.as_tensor(t.walk_starts, device=dev)[torch.randint(
        0, len(t.walk_starts), (b_w * lay.model_size,), generator=data,
        device=dev)]
    walks = random_walks(t.csr, starts, cfg.walk_length, data)
    walks = t._model_slice(walks[None])[0]
    wrow = torch.randint(1, cfg.window + 1, (G * NWL,), generator=mine,
                         device=dev, dtype=torch.int32)
    pools1 = sample_alias(t.accept, t.alias, mine, (n_pools, KP))
    out["K1"] = held_step(t, (p.node_emb, p.ctx_emb), walks, wrow, pools1,
                          t.lr(), t.negw, cfg.window, False, "row-sharded K1")
    # K5: the data row's packed edge rows, this worker's slice
    B_r, _ = t.o2_paired_plan()
    b_w, _, n_pools = t._rowsharded_o2_shapes()
    uu, vv = t._undirected_edges()
    idx = torch.randint(0, uu.shape[0], (B_r // D * 64,), generator=data,
                        device=dev)
    rows = torch.stack([uu[idx], vv[idx]], 1).reshape(1, B_r // D, 128)
    rows = t._model_slice(rows)[0]
    pools = sample_alias(t.accept, t.alias, mine, (n_pools, KP))
    out["K5"] = held_step(t, (p.node_emb,), rows, None, pools,
                          t.lr() * cfg.alpha, t.negw, 1, True,
                          "row-sharded K5")
    # both steps again on shards WIDE_D wide drawn from this rank's seed:
    # past MAX_DIM the band pass holds the compact rows whole where they
    # fit and stages column slabs where they do not
    wide = torch.Generator(device=dev).manual_seed(SEED + 4000 + rank)
    shards = [torch.randn((p.node_emb.shape[0], WIDE_D), generator=wide,
                          device=dev) * 0.1 for _ in range(2)]
    out[f"K1_d{WIDE_D}"] = held_step(
        t, shards, walks, wrow, pools1, t.lr(), t.negw, cfg.window, False,
        f"row-sharded K1 d {WIDE_D}")
    out[f"K5_d{WIDE_D}"] = held_step(
        t, shards[:1], rows, None, pools, t.lr() * cfg.alpha, t.negw, 1,
        True, f"row-sharded K5 d {WIDE_D}")
    return out


def synthetic_step(t) -> dict:
    """One row-sharded K1 step at the synthetic-10m shapes: this rank's
    [V/M, d] shards drawn from its seed, the workers' 1024 walks of 80
    uniform over V, KP 2048."""
    from come_tpu_torch.ops.walk_sgns import NW, NWL

    cfg, dev, lay = t.cfg, t.device, t.layout
    V, B, KP = SYNTH["V"], SYNTH["B"], SYNTH["KP"]
    M, d = lay.model_size, cfg.dim
    g = torch.Generator(device=dev).manual_seed(SEED + 3000 + lay.rank)
    shards = [torch.randn((V // M, d), generator=g, device=dev) * 0.1
              for _ in range(2)]
    b_w = B // (lay.data_size * M)
    G = -(-b_w // NW)
    walks = torch.randint(0, V, (b_w, cfg.walk_length), generator=g,
                          device=dev, dtype=torch.int32)
    wrow = torch.randint(1, cfg.window + 1, (G * NWL,), generator=g,
                         device=dev, dtype=torch.int32)
    pools = torch.randint(0, V, (G, KP), generator=g, device=dev,
                          dtype=torch.int32)
    return held_step(t, shards, walks, wrow, pools, t.lr(),
                     cfg.negative / KP, cfg.window, False,
                     "synthetic-10m row-sharded K1")


def metered_epoch(t, epoch) -> dict:
    """One more epoch with every collective between CUDA events."""
    from come_tpu_torch.parallel.collectives import METER

    METER.reset()
    METER.timing = True
    t._sync()
    t0 = time.perf_counter()
    epoch()
    t._sync()
    ms = (time.perf_counter() - t0) * 1e3
    METER.timing = False
    return {"ms": ms, "a2a_calls": METER.a2a_calls,
            "a2a_bytes": METER.a2a_bytes, "a2a_ms": METER.a2a_ms(),
            "allreduce_calls": METER.calls, "allreduce_bytes": METER.bytes,
            "allreduce_ms": METER.ms(), "transport": METER.transport}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mesh", required=True, help="D,M")
    p.add_argument("--backend", choices=["nccl", "gloo"])
    p.add_argument("--device", default="cuda",
                   help="this rank's device (default cuda:LOCAL_RANK)")
    p.add_argument("--dataset", default="blogcatalog")
    p.add_argument("--walks-per-node", type=int)
    p.add_argument("--synthetic", action="store_true",
                   help="also hold a K1 step at the synthetic-10m shapes")
    p.add_argument("--dim", type=int, default=128,
                   help="the tables' width (default 128; the held steps "
                   "also run at WIDE_D)")
    p.add_argument("--out", help="write rank<r>.json here")
    args = p.parse_args(argv)

    import torch.distributed as dist

    from come_tpu_torch.main import build_argparser, run
    from come_tpu_torch.tools.dp_check import COUNTERS

    world = int(os.environ.get("WORLD_SIZE", "1"))
    cli = ["--dataset", args.dataset, "--mesh", args.mesh,
           "--pretrain-epochs", "1", "--outer-iters", "1", "--seed",
           str(SEED), "--device", args.device, "--dim", str(args.dim)]
    if args.backend:
        cli += ["--backend", args.backend]
    if args.walks_per_node:
        cli += ["--walks-per-node", str(args.walks_per_node)]
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)
    launch_plan.reset_counts()
    try:
        t0 = time.perf_counter()
        trainer, hist = run(build_argparser().parse_args(cli))
        trainer._sync()
        wall = time.perf_counter() - t0
        launches = {k: getattr(fn, attr)
                    for k, (fn, attr) in COUNTERS.items()}
        rec = hist[-1]
        lay = trainer.layout
        res = {"rank": trainer.rank, "world": world,
               "mesh": [lay.data_size, lay.model_size],
               "data_index": lay.data_index, "model_index": lay.model_index,
               "backend": dist.get_backend(), "device": str(trainer.device),
               "wall_s": wall, "nmi": rec["nmi"], "launches": launches,
               "graphs": launch_plan.graph_counts(),
               "o1_tier": trainer.o1_tier(), "o2_tier": trainer.o2_tier(),
               "o1_served": trainer.last_o1_served,
               "o2_served": trainer.last_o2_served,
               "hash": param_hash(trainer.params)}
        for k in ("gmm_ms", "o1_ms", "o2_ms", "o3_ms", "o1_pairs",
                  "o2_pairs"):
            res[k] = rec[k]
        res["o1"] = metered_epoch(trainer, trainer.o1_epoch)
        res["o2"] = metered_epoch(trainer, trainer.o2_epoch)
        cfg, g = trainer.cfg, trainer.mesh_workers
        n = len(trainer.walk_starts) * cfg.walks_per_node
        B = max(g, min(cfg.batch_walks, n) // g * g)
        res["o1"]["steps"] = -(-n // B)
        res["o2"]["steps"] = trainer.o2_paired_plan()[1]
        res["hash_after"] = param_hash(trainer.params)
        res["held"] = held_steps(trainer)
        if args.synthetic:
            res["synthetic"] = synthetic_step(trainer)
        line = json.dumps(res)
        print(line, flush=True)
        if args.out:
            Path(args.out).mkdir(parents=True, exist_ok=True)
            (Path(args.out) / f"rank{trainer.rank}.json").write_text(line)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
