"""Per-pass device time of the SGNS kernels' steps on one card.

    python come_tpu_torch/tools/pass_times.py [--root DIR] [--label NAME]

At ``chip_smoke.py``'s shapes, on the BlogCatalog stand-in (d 128, KP 512,
lr 0.025, negw 5 / KP, tables and draws from seed 0), it times the steps
that carry the f32 negative pass and the star pass:

  * K1   one O1 macro step of 256 walks of 80 (W 10, 32 groups, R 1);
  * K2   one star O2 step of 512 random layout rows (64 groups, R 1);
  * K2b  the bench path's star step in bf16 (the whole layout, R 8);
  * K5   one paired O2 step of 512 rows of 64 edges (64 groups);
  * K6   one micro-step of 32768 window pairs (32 tiles of 1024, KP 512);
  * K7   the same on one tied table with 32768 arcs.

Each step runs on tables it updates in place.  For each it prints one JSON
line: the card's name and power limit, the step's CUDA-event ms (median of
5 after one warm-up), the device µs per group (per tile for K6/K7) of each
pass of its loop and of all its kernels (``torch.profiler``), and the busy
share (all kernels' device time over the CUDA-event time).

``--root`` times the ``come_tpu_torch`` package of another checkout, with
kernels built from that checkout's ``csrc/``, so two trees compare on one
card in one call (run the file by its path, not with ``-m``).  Needs a CUDA
card.  ``chip_smoke.py`` reads its pass tables from here.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

# each group loop by pass: (name, substring of its CUDA kernel's name)
WALK_PASSES = (("band", "walk_pos_kernel"), ("negative", "negative_"),
               ("scatter", "walk_scatter"), ("stage", "stage_pool"),
               ("pool apply", "apply_pool"))
STAR_PASSES = (("star", "star_pos_kernel"), ("negative", "negative_"),
               ("scatter", "star_scatter"), ("stage", "stage_pool"),
               ("pool apply", "apply_pool"))
FUSED_PASSES = (("positive", "fused_pos_kernel"), ("negative", "negative_"),
                ("scatter", "fused_scatter"))


def device_us(fn, ids, kernel=None, required=True):
    """Device microseconds per call of ``fn(i)`` over ``ids``, summed over
    the CUDA kernels whose name holds ``kernel`` (every kernel with None;
    torch.profiler): at small sizes a call's host overhead outlasts its
    kernel, and CUDA events then time the host.  A tuple of names gives a
    tuple of sums from the one profiled run.  A kernel that no session
    records raises, or reads None where ``required`` is False."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    names = kernel if isinstance(kernel, tuple) else (kernel,)
    fn(ids[0])
    torch.cuda.synchronize()
    # up to four sessions: late in a long run a short profiler session on
    # the H100 may record no kernel (P1's 262144-row f32 sessions, often)
    for attempt in range(4):
        if attempt:
            time.sleep(0.5)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in ids:
                fn(i)
            torch.cuda.synchronize()
        events = prof.key_averages()
        sums = [sum(e.device_time_total for e in events
                    if k is None or k in e.key) / len(ids) for k in names]
        if min(sums) > 0:
            return tuple(sums) if isinstance(kernel, tuple) else sums[0]
    missing = [k or "CUDA" for k, t in zip(names, sums) if t <= 0]
    if required:
        raise AssertionError(f"the profiler saw no {missing} kernel")
    sums = [t if t > 0 else None for t in sums]
    return tuple(sums) if isinstance(kernel, tuple) else sums[0]


def pass_split(fn, groups: int, passes=WALK_PASSES):
    """Device microseconds per group of each of ``passes`` over two calls
    of ``fn`` (a step of ``groups`` groups or tiles), as a dict, and the
    device microseconds per call of every kernel it runs."""
    *us, total = device_us(lambda i: fn(), [0, 1],
                           tuple(k for _, k in passes) + (None,))
    return {name: t / groups for (name, _), t in zip(passes, us)}, total


def split_text(split: dict) -> str:
    return ", ".join(f"{k} {v:.2f}" for k, v in split.items())


def cuda_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event milliseconds of ``fn()`` after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def steps(dev):
    """(name, step(), groups or tiles, passes) at chip_smoke.py's shapes;
    each step updates its own tables in place."""
    import numpy as np
    import torch

    from come_tpu_torch.graphs import get_dataset
    from come_tpu_torch.ops.sgns import fused_sgns_step, fused_sgns_step_tied
    from come_tpu_torch.ops.star_sgns import star_sgns_step
    from come_tpu_torch.ops.walk_sgns import walk_sgns_step
    from come_tpu_torch.sampling import (
        build_alias_table,
        build_star_layout,
        random_walks,
        sample_alias,
        unigram_weights,
    )
    from come_tpu_torch.sampling.stars import PAD_META
    from come_tpu_torch.sampling.windows import (
        skipgram_pairs,
        subsample_keep_probs,
    )

    ds = get_dataset("blogcatalog")
    V, d, B, L, W, KP = ds.graph.num_nodes, 128, 256, 80, 10, 512
    lr, negw = 0.025, 5.0 / KP
    gen = torch.Generator(device=dev).manual_seed(0)
    emb_in = torch.randn((V, d), generator=gen, device=dev) * 0.1
    emb_out = torch.randn((V, d), generator=gen, device=dev) * 0.1
    csr = ds.graph.to_device(dev)
    walks = random_walks(csr, torch.randint(0, V, (B,), generator=gen,
                                            device=dev), L, gen)
    G = B // 8
    wrow = torch.randint(1, W + 1, (G * 1024,), generator=gen, device=dev,
                         dtype=torch.int32)
    pools = torch.randint(0, V, (G, KP), generator=gen, device=dev,
                          dtype=torch.int32)
    out = [("K1", lambda: walk_sgns_step(emb_in, emb_out, walks, wrow, pools,
                                         lr, negw, window=W, pool_refresh=1),
            G, WALK_PASSES)]

    u, v = ds.graph.edges_undirected()
    slots, meta = build_star_layout(u, v, V)
    lay_s, lay_m = slots.reshape(-1, 128), meta.reshape(-1, 128)
    perm = np.random.default_rng(0).permutation(lay_s.shape[0])[:512]
    sl = torch.as_tensor(lay_s[perm], device=dev).reshape(-1)
    mt = torch.as_tensor(lay_m[perm], device=dev).reshape(-1)
    G2 = sl.numel() // 1024
    pools2 = torch.randint(0, V, (G2, KP), generator=gen, device=dev,
                           dtype=torch.int32)
    out.append(("K2", lambda: star_sgns_step(emb_in, sl, mt, pools2, lr, negw,
                                             pool_refresh=1), G2, STAR_PASSES))

    # the bench path's star step: the whole layout in ceil(NR / 8) * 8
    # rows, alias pools, R 8, bf16
    NR, RB = lay_s.shape[0], 8
    rps = -(-NR // 8) * 8
    rperm = np.random.default_rng(0).permutation(NR)
    sl_b = torch.as_tensor(np.pad(lay_s[rperm], ((0, rps - NR), (0, 0))),
                           device=dev).reshape(-1)
    mt_b = torch.as_tensor(np.pad(lay_m[rperm], ((0, rps - NR), (0, 0)),
                                  constant_values=PAD_META),
                           device=dev).reshape(-1)
    G2B = rps * 128 // 1024
    accept, alias = (torch.as_tensor(a, device=dev) for a in
                     build_alias_table(unigram_weights(ds.graph.degrees)))
    pools_b = sample_alias(accept, alias, gen, (-(-G2B // RB), KP))
    out.append(("K2b bench", lambda: star_sgns_step(
        emb_in, sl_b, mt_b, pools_b, lr, negw, pool_refresh=RB,
        mxu_bf16=True), G2B, STAR_PASSES))

    eperm = torch.as_tensor(np.random.default_rng(0).permutation(
        u.shape[0])[:512 * 64], device=dev)
    uu, vv = (torch.as_tensor(a, device=dev)[eperm] for a in (u, v))
    rows = torch.stack([uu, vv], 1).reshape(512, 128)
    pools5 = torch.randint(0, V, (64, KP), generator=gen, device=dev,
                           dtype=torch.int32)
    out.append(("K5", lambda: walk_sgns_step(
        emb_in, emb_out, rows, None, pools5, lr, negw, window=1,
        pool_refresh=1, paired=True), 64, WALK_PASSES))

    keep = torch.as_tensor(subsample_keep_probs(ds.graph.degrees, 1e-3),
                           device=dev)
    c, x, m = (a.reshape(-1)[:32768] for a in
               skipgram_pairs(walks, W, gen, keep))
    pool = sample_alias(accept, alias, gen, (KP,))
    out.append(("K6", lambda: fused_sgns_step(emb_in, emb_out, c, x, pool, m,
                                              lr, negw, tile_pairs=1024),
                32, FUSED_PASSES))
    src, dst = (torch.as_tensor(a, device=dev) for a in ds.graph.arcs())
    arcs = torch.randperm(src.numel(), generator=gen, device=dev)[:32768]
    ones = torch.ones(arcs.numel(), device=dev)
    out.append(("K7", lambda: fused_sgns_step_tied(
        emb_in, src[arcs], dst[arcs], pool, ones, lr, negw, tile_pairs=1024),
        32, FUSED_PASSES))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                   help="the checkout whose come_tpu_torch to time")
    p.add_argument("--label", default="", help="a name for the JSON lines")
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("pass_times: needs a CUDA card")
    import come_tpu_torch
    from come_tpu_torch.ops import build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    build.library()
    for name, step, groups, passes in steps(dev):
        ms = cuda_ms(step)
        split, total = pass_split(step, groups, passes)
        print(json.dumps({
            "card": card, "label": args.label,
            "package": str(Path(come_tpu_torch.__file__).parent),
            "step": name, "groups": groups, "ms": ms,
            "us_per_group": split, "device_us_per_group": total / groups,
            "busy": total / (ms * 1e3),
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
