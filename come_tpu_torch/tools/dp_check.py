"""One rank of the data-parallel check on the card.

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        -m come_tpu_torch.tools.dp_check [--backend nccl|gloo] \\
        [--device cuda:0] [--dim D] [--walks-per-node W] [--out DIR]

Each rank trains the blogcatalog preset through the CLI's entry
(``main.run`` with ``--mesh N,1``, pretrain 1 + outer 1, ``--dim D``: 128
by default; every held step below takes the tables' width; ``--walks-per-node
W`` cuts the preset's walks a node), with the
kernels' launch counters set to 0 just before and read just after, then:

* times one more O1 epoch, with CUDA events around every all-reduce
  (``parallel/collectives.py``'s meter): the epoch's ms, the all-reduce
  ms, calls and bytes;
* times the single-device EM and the distributed one on the trained
  table, in turns (median of 3 after a warm-up of each), and at world 1
  O1 epochs of the single-device trainer and the data-parallel one on the
  same table, in turns (four each);
* hashes the six parameter tensors (sha256 of their bytes) after the run
  and after that epoch, so the caller can hold the replicas bit-identical;
* holds one data-parallel step of K1 (256 walks of 80 at
  BlogCatalog shapes, W 10, KP 512), K2 (512 star-layout rows), K5 (512
  rows of 64 edges) through the trainer's step methods, and one of K3 (bf16
  tables at the synthetic-10m shapes: V 500000, d D, 1024 walks of 80,
  W 10, KP 2048, SR) through ``collectives.reduce_deltas_``, each rank on
  its own inputs (seeded by rank), each held against ``before + sum_r
  (plain_r(before) - before)``, which every rank computes for all ranks.
  K1, K2 and K5 take the f32 check, ``|upd - plain upd| <= 1e-6 + 1e-4
  |plain upd|``, with ``tools/hot_row.py``'s rule where it fails (the
  plain steps then run in float64); K3 ``ops/tolerance.py``'s K3 check
  against the plain K3 steps, with the plain K1b steps on f32 tables as
  its f32 side.

It prints one JSON line per rank and writes it to ``DIR/rank<r>.json``; a
failed check raises, so the rank and the launcher exit non-zero.  Over
gloo the card's tensors are staged through the host by the backend: its
times measure correctness, not speed.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import time
from pathlib import Path

import torch

from come_tpu_torch.ops import launch_plan
from come_tpu_torch.ops.sgns import fused_sgns_step, fused_sgns_step_tied
from come_tpu_torch.ops.star_sgns import star_sgns_step
from come_tpu_torch.ops.walk_sgns import walk_sgns_gen_step, walk_sgns_step

SEED = 0
# the held K1 step's walks; the held K3 step's shapes (synthetic-10m's)
K1_WALKS = 256
K3_SHAPE = dict(V=500000, B=1024, KP=2048)


# each kernel (mode) of the trainer's paths and the wrapper attribute that
# counts its launches
COUNTERS = {
    "walk_sgns": (walk_sgns_step, "launches"),
    "walk_sgns_bf16": (walk_sgns_step, "launches_bf16"),
    "walk_sgns_paired": (walk_sgns_step, "launches_paired"),
    "walk_sgns_bf16_tables": (walk_sgns_step, "launches_bf16_tables"),
    "walk_sgns_gen": (walk_sgns_gen_step, "launches"),
    "walk_sgns_gen_bf16": (walk_sgns_gen_step, "launches_bf16"),
    "star_sgns": (star_sgns_step, "launches"),
    "star_sgns_bf16": (star_sgns_step, "launches_bf16"),
    "fused_sgns": (fused_sgns_step, "launches"),
    "fused_sgns_tied": (fused_sgns_step_tied, "launches"),
}


def param_hash(params) -> str:
    h = hashlib.sha256()
    for t in params.to_numpy().values():
        h.update(t.tobytes())
    return h.hexdigest()[:16]


def f32_ratio(init, got, ref) -> float:
    """Worst |update - reference update| / (1e-6 + 1e-4 |reference
    update|) over every element (the f32 check passes at <= 1)."""
    from come_tpu_torch.tools.hot_row import worst_ratio

    return worst_ratio(init, got, ref)


def summed(before, outs):
    """``before + sum_r (out_r - before)``, in the dtype of ``outs``."""
    acc = before.to(outs[0].dtype)
    return acc + sum(o - acc for o in outs)


def o1_ab(t) -> dict:
    """O1 epoch ms of the single-device trainer and of the data-parallel
    one ``t`` (world 1) on the same table, in turns (single, dp, dp,
    single, twice): what the data-parallel rule costs at one rank."""
    from come_tpu_torch.trainer import ComETrainer

    one = ComETrainer(t.graph, t.cfg, t.device, t.seed)
    for name, buf in t.params.named_buffers():
        getattr(one.params, name).copy_(buf)
    times = {"single": [], "dp": []}
    for name in ("single", "dp", "dp", "single") * 2:
        tr = one if name == "single" else t
        t._sync()
        t0 = time.perf_counter()
        tr.o1_epoch()
        t._sync()
        times[name].append((time.perf_counter() - t0) * 1e3)
    return times


def gmm_ab(t, reps: int = 3) -> dict:
    """Median ms of the single-device EM (``gmm_em_fit``) and of the
    distributed one (``gmm_em_fit_sharded``) on the trainer's table, each
    from a host generator in the same state, in turns after one warm-up
    of each."""
    import statistics

    from come_tpu_torch.losses.gmm import gmm_em_fit, gmm_em_fit_sharded

    cfg, X = t.cfg, t.params.node_emb
    kw = dict(n_init=cfg.gmm_n_init, max_iter=cfg.gmm_max_iter,
              reg_covar=cfg.reg_covar, tol=cfg.gmm_tol)
    fits = {
        "single": lambda g: gmm_em_fit(X, cfg.num_communities, g, **kw),
        "sharded": lambda g: gmm_em_fit_sharded(
            X, None, cfg.num_communities, g, t.group, **kw),
    }
    times = {k: [] for k in fits}
    for i in range(reps + 1):
        for k, fn in fits.items():
            t._sync()
            t0 = time.perf_counter()
            fn(torch.Generator().manual_seed(i))
            t._sync()
            if i:
                times[k].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in times.items()}


def held_steps(t, world: int, rank: int) -> dict:
    """The held dp steps of K1, K2, K5 (through ``t``) and K3."""
    from come_tpu_torch.ops.star_sgns import star_sgns_step_reference
    from come_tpu_torch.ops.tolerance import check_k3
    from come_tpu_torch.ops.walk_sgns import (
        NW,
        NWL,
        walk_sgns_step,
        walk_sgns_step_reference,
    )
    from come_tpu_torch.parallel.collectives import reduce_deltas_
    from come_tpu_torch.sampling import random_walks

    dev, cfg, p = t.device, t.cfg, t.params
    V, d = p.node_emb.shape
    B, L, W, KP = K1_WALKS, cfg.walk_length, cfg.window, cfg.shared_negatives
    G = B // NW
    lr, negw = t.lr(), t.negw  # each step reads the rate it trains at

    def gen(r):
        return torch.Generator(device=dev).manual_seed(SEED + 1000 + r)

    def k1_inputs(r):
        g = gen(r)
        starts = torch.randint(0, V, (B,), generator=g, device=dev)
        walks = random_walks(t.csr, starts, L, g)
        wrow = torch.randint(1, W + 1, (G * NWL,), generator=g, device=dev,
                             dtype=torch.int32)
        pools = torch.randint(0, V, (G, KP), generator=g, device=dev,
                              dtype=torch.int32)
        return walks, wrow, pools

    out = {}
    before = (p.node_emb.clone(), p.ctx_emb.clone())
    t.o1_step(*k1_inputs(rank))
    got = (p.node_emb.clone(), p.ctx_emb.clone())

    def k1_plain(acc=None):
        outs = []
        for r in range(world):
            tabs = [x.clone() if acc is None else x.double() for x in before]
            outs.append(walk_sgns_step_reference(
                *tabs, *k1_inputs(r), lr, negw, window=W, pool_refresh=1,
                **({} if acc is None else {"acc": acc}))[:2])
        return [summed(before[i], [o[i] for o in outs]) for i in range(2)]

    ratio = f32_ratio(before, got, k1_plain())
    out["K1"] = {"f32_ratio": ratio}
    if ratio > 1.0:  # tools/hot_row.py's rule: the plain steps in float64
        ratio = f32_ratio(before, got, k1_plain(torch.float64))
        out["K1"]["f64_ratio"] = ratio
    if ratio > 1.0:
        raise AssertionError(f"dp K1 step: worst ratio {ratio:.3f} > 1")

    rs, rm = t._star_layout()
    alr = t.lr() * cfg.alpha
    n2 = min(512, rs.shape[0] // NW * NW)  # layout rows, whole groups

    def k2_inputs(r):
        g = gen(r)
        rows = torch.randperm(rs.shape[0], generator=g, device=dev)[:n2]
        pools = torch.randint(0, V, (n2 // NW, KP), generator=g, device=dev,
                              dtype=torch.int32)
        return rs[rows].reshape(-1), rm[rows].reshape(-1), pools

    before = p.node_emb.clone()
    t.o2_step(*k2_inputs(rank), 1.0)
    want = summed(before, [star_sgns_step_reference(
        before.clone(), *k2_inputs(r), alr, negw, pool_refresh=1)[0]
        for r in range(world)])
    ratio = f32_ratio([before], [p.node_emb], [want])
    out["K2"] = {"f32_ratio": ratio}
    if ratio > 1.0:
        raise AssertionError(f"dp K2 step: worst ratio {ratio:.3f} > 1")

    uu, vv = t._undirected_edges()

    def k5_inputs(r):
        g = gen(r)
        idx = torch.randint(0, uu.shape[0], (512 * 64,), generator=g,
                            device=dev)
        rows = torch.stack([uu[idx], vv[idx]], 1).reshape(512, 128)
        pools = torch.randint(0, V, (64, KP), generator=g, device=dev,
                              dtype=torch.int32)
        return rows, pools

    alr = t.lr() * cfg.alpha
    before = p.node_emb.clone()
    t.o2_paired_step(*k5_inputs(rank))
    want = before.clone()
    for r in range(world):
        rows, pools = k5_inputs(r)
        ni, no = walk_sgns_step_reference(
            before.clone(), before.clone(), rows, None, pools, alr, negw,
            window=1, pool_refresh=1, paired=True)[:2]
        want += ni + no - 2.0 * before
    ratio = f32_ratio([before], [p.node_emb], [want])
    out["K5"] = {"f32_ratio": ratio}
    if ratio > 1.0:
        raise AssertionError(f"dp K5 step: worst ratio {ratio:.3f} > 1")

    # K3: bf16 tables at the synthetic-10m shapes, uniform walks
    V3, B3, KP3 = K3_SHAPE["V"], K3_SHAPE["B"], K3_SHAPE["KP"]
    G3 = B3 // NW
    g0 = torch.Generator(device=dev).manual_seed(SEED)
    init = [(torch.randn((V3, d), generator=g0, device=dev) * 0.1).to(
        torch.bfloat16) for _ in range(2)]

    def k3_inputs(r):
        g = gen(r)
        walks = torch.randint(0, V3, (B3, L), generator=g, device=dev,
                              dtype=torch.int32)
        wrow = torch.randint(1, W + 1, (G3 * NWL,), generator=g, device=dev,
                             dtype=torch.int32)
        pools = torch.randint(0, V3, (G3, KP3), generator=g, device=dev,
                              dtype=torch.int32)
        return walks, wrow, pools

    negw3 = cfg.negative / KP3
    lr = t.lr()
    tabs = [x.clone() for x in init]
    # the trainer's rule around a K3 step: a snapshot of both tables, the
    # step, the f32 reduction; the first and last between CUDA events
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)] \
        if dev.type == "cuda" else None
    if ev:
        ev[0].record()
    before = [x.clone() for x in tabs]
    if ev:
        ev[1].record()
    walk_sgns_step(*tabs, *k3_inputs(rank), lr, negw3, window=W,
                   pool_refresh=1, sr_seed=12345 + rank)
    if ev:
        ev[2].record()
    reduce_deltas_(tabs, before, t.group)
    if ev:
        ev[3].record()
        torch.cuda.synchronize(dev)
        out["K3_rule_ms"] = ev[0].elapsed_time(ev[1]) + ev[2].elapsed_time(
            ev[3])
    del before

    def plain3(tables, r, **kw):
        return walk_sgns_step_reference(
            *[x.clone() for x in tables], *k3_inputs(r), lr, negw3,
            window=W, pool_refresh=1, **kw)[:2]

    want, f32 = [], []
    k3_outs = [plain3(init, r, sr_seed=12345 + r) for r in range(world)]
    init32 = [x.float() for x in init]
    k1b_outs = [plain3(init32, r, mxu_bf16=True) for r in range(world)]
    for i in range(2):
        want.append(summed(init[i].float(), [o[i].float() for o in k3_outs])
                    .to(torch.bfloat16))
        f32.append(summed(init32[i], [o[i] for o in k1b_outs]))
    err = check_k3("dp K3 step", init, tabs, want, f32)
    out["K3"] = {"identical": err[3], "rel_l2": err[1], "f32_distance":
                 err[2], "max_abs": err[0],
                 "rule_ms": out.pop("K3_rule_ms", None)}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--backend", choices=["nccl", "gloo"])
    p.add_argument("--device", default="cuda",
                   help="this rank's device (default cuda:LOCAL_RANK)")
    p.add_argument("--dim", type=int, default=128,
                   help="the tables' width (default 128)")
    p.add_argument("--walks-per-node", type=int,
                   help="walks a node (default: the preset's)")
    p.add_argument("--out", help="write rank<r>.json here")
    args = p.parse_args(argv)

    import torch.distributed as dist

    from come_tpu_torch.main import build_argparser, run
    from come_tpu_torch.parallel.collectives import METER

    world = int(os.environ.get("WORLD_SIZE", "1"))
    cli = ["--dataset", "blogcatalog", "--mesh", f"{world},1",
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
        res = {"rank": trainer.rank, "world": world,
               "backend": dist.get_backend(), "device": str(trainer.device),
               "wall_s": wall, "nmi": rec["nmi"], "launches": launches,
               "graphs": launch_plan.graph_counts(),
               "o1_tier": trainer.o1_tier(), "o2_tier": trainer.o2_tier(),
               "hash": param_hash(trainer.params)}
        for k in ("gmm_ms", "o1_ms", "o2_ms", "o3_ms", "o1_pairs",
                  "o2_pairs"):
            res[k] = rec[k]
        # one more O1 epoch, every all-reduce between CUDA events
        METER.reset()
        METER.timing = True
        trainer._sync()
        t0 = time.perf_counter()
        trainer.o1_epoch()
        trainer._sync()
        res["epoch_ms"] = (time.perf_counter() - t0) * 1e3
        METER.timing = False
        steps = METER.calls - 1  # the epoch's one loss/pairs reduction
        res.update(o1_steps=steps, allreduce_ms=METER.ms(),
                   allreduce_calls=METER.calls, allreduce_bytes=METER.bytes,
                   hash_after=param_hash(trainer.params))
        res["gmm_ab_ms"] = gmm_ab(trainer)
        if world == 1:
            res["o1_ab_ms"] = o1_ab(trainer)
        res["held"] = held_steps(trainer, world, trainer.rank)
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
