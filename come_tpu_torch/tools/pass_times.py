"""Per-pass device time of the SGNS kernels' steps on one card.

    python come_tpu_torch/tools/pass_times.py [--root DIR] [--label NAME]
        [--steps K1 K2 ...] [--trace] [--run N] [--dim D]

At ``chip_smoke.py``'s shapes, on the BlogCatalog stand-in (d 128, KP 512,
lr 0.025, negw 5 / KP, tables and draws from seed 0), it times the steps
that carry the f32 negative pass and the star pass:

  * K1   one O1 macro step of 256 walks of 80 (W 10, 32 groups, R 1);
  * K1b bench  the bench path's O1 step in bf16 (2048 walks, 256 groups,
         R 8, alias pools);
  * K4 bench  the same with its walks generated on the card (K4), its
         walk generation timed and bounded as a pass of its own ("gen");
  * K2   one star O2 step of 512 random layout rows (64 groups, R 1);
  * K2b  the bench path's star step in bf16 (the whole layout, R 8);
  * K5   one paired O2 step of 512 rows of 64 edges (64 groups);
  * K6   one micro-step of 32768 window pairs (32 tiles of 1024, KP 512);
  * K7   the same on one tied table with 32768 arcs;
  * K6 karate, K7 karate  the same at karate's shared-negative shapes
         (``chip_smoke.py`` phase 9: d 16, 128 pairs in tiles of 64, KP 32);
  * K3   one O1 step on bf16 tables at the synthetic-10m shapes (V 500000,
         1024 walks of 80 drawn uniformly over V, KP 2048, 128 groups, SR);
  * K6 scan, K6 karate scan  a macro batch of 8 K6 micro-steps at K6's
         and at karate's shapes as one scan (``fused_sgns_scan``: one
         launch of a WHILE graph); their lines add ``per_micro_ms``: ms a
         micro-step of the scan from an idle card and in a run, and of the
         same micro-steps called one by one in a run (``loop``).

``--dim`` makes the tables that wide (karate's stay 16); past 192 every
step runs through its wide band or star pass (whole rows held in shared
memory where they fit, else column slabs: the line's ``route``) and the
wide negative pass (``csrc/sgns_common.cuh``: NEG_WHOLE).  The K1, K1b
bench, K4 bench, K2, K2b bench, K5 and K3 lines add
``bound_us_per_group``: each pass's least µs a group, by bytes or
operations, from the step's own inputs (:func:`pass_bounds`).  A walk
step on f32 tables, and a star step, writes a block's pool in the scatter
of its last group ("block-end scatter"; the other groups' "scatter", and
no "pool apply"): its line adds ``scatter_us_per_launch``, each of the two
a launch.  Each
step runs on tables it
updates in place.  For each it prints one JSON
line: the card's name and power limit, the step's CUDA-event ms (median of
5 after one warm-up, each from an idle card), its ms per step over
``--run`` steps in a row (``chained_ms``; 10 by default) and, for a step
that runs through a launch plan, per launch of ``--run`` launches of the
graph its last call recorded (``replay_ms``: no host work; and
``run_minus_replay_ms``, ``idle_minus_replay_ms``: what a step in a run
and one from an idle card cost beyond it), all taken
before the first profiled run, the device µs
per group (per tile for K6/K7) of each pass of its loop and of all its
kernels (``torch.profiler``), and the busy share (all kernels' device time
over the CUDA-event time).

``--trace`` adds to each line what one profiled run of two steps shows on
the device's timeline (:func:`timeline`): the gaps between consecutive
kernels of a step (median and spread, by which pass follows which; a
negative gap is an overlap, as programmatic dependent launch allows), the
share of the step's span that some kernel covers, the µs a group each
pass adds to the span (``critical_us_per_group``), and the host's enqueue
time per step, measured for every step before the first profiled run
(:func:`host_times`: the whole wrapper call, the C entry's share of it,
the allocation of six scratch buffers, as a wrapper that made its scratch
per call would, :func:`enqueue_ms` over ``--run`` steps in a row, and for
K1 and K2 a fit of the C entry's time over 1 to 32 or 64 groups, whose
intercept is its fixed cost per call: setup and, with graphs, recording,
update and replay).  With programmatic dependent launch a kernel's device
time includes the time it waits for its predecessor, so its pass µs
overlap and the kernels' sum may pass the step's time: the covered share
is then the busy share to read.

The same lines add ``library_us_per_group``: the stage, the pool apply and
the scatter each as one PyTorch call at the step's shapes
(:func:`library_us`: index_select into the dtype the stage writes,
index_add_; the calls' names under "calls"), µs a group.  The walk and
star steps' lines add ``pool_chains_us_per_step`` and
``slot_chains_us_per_step``: the device µs a step of its pools' and its
groups' slots' sorts (also in the pass "chains" with the fold chains, µs a
group).

Each line also has ``library3_ms``: one group's (tile's) negative pass as
three PyTorch products at its shapes (:func:`library3_ms`: scores, the
sigmoid, dphi and dneg; f32 with TF32 off, or bf16 operands with f32
output where the step's pass takes bf16 products), a yardstick the port
never calls.

``--root`` times the ``come_tpu_torch`` package of another checkout, with
kernels built from that checkout's ``csrc/``, so two trees compare on one
card in one call (run the file by its path, not with ``-m``).  Needs a CUDA
card.  ``chip_smoke.py`` reads its pass tables from here.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# each group loop by pass: (name, substring of its CUDA kernel's name)
# kernel names by pass (a substring; past d 192 the band and star passes
# are the *_wide_kernel or *_slab_kernel forms, the negative passes the
# *_wide_kernel ones)
WALK_PASSES = (("band", "walk_pos_"), ("negative", "negative_"),
               ("scatter", "walk_scatter"), ("stage", "stage_pool"),
               ("pool apply", "apply_pool"),
               ("block-end scatter", "block_end_scatter"),
               ("chains", "_chains_kernel"))
# K4's step: the walk passes and its walk generation, once a step
WALK_GEN_PASSES = WALK_PASSES + (("gen", "walk_gen"),)
# the star steps write as the f32 walk steps do (the block end's pool write
# in its scatter, the chains once a step); "pool apply" reads a tree whose
# star steps still launch apply_pool_kernel
STAR_PASSES = (("star", "star_pos_"), ("negative", "negative_"),
               ("scatter", "star_scatter"), ("stage", "stage_pool"),
               ("pool apply", "apply_pool"),
               ("block-end scatter", "star_block_end_scatter"),
               ("chains", "_chains_kernel"))
FUSED_PASSES = (("positive", "fused_pos_kernel"), ("negative", "negative_"),
                ("scatter", "fused_scatter"), ("stage", "stage_"),
                ("pool apply", "apply_"))


def device_us(fn, ids, kernel=None, required=True, some=False):
    """Device microseconds per call of ``fn(i)`` over ``ids``, summed over
    the CUDA kernels whose name holds ``kernel`` (every kernel with None;
    torch.profiler): at small sizes a call's host overhead outlasts its
    kernel, and CUDA events then time the host.  A tuple of names gives a
    tuple of sums from the one profiled run.  A kernel that no session
    records raises, or reads None where ``required`` is False; with
    ``some`` a session that records any of the names is read at once (the
    names a step does not launch read None)."""
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
        if min(sums) > 0 or (some and max(sums) > 0):
            break
    missing = [k or "CUDA" for k, t in zip(names, sums) if t <= 0]
    if required and missing:
        raise AssertionError(f"the profiler saw no {missing} kernel")
    sums = [t if t > 0 else None for t in sums]
    return tuple(sums) if isinstance(kernel, tuple) else sums[0]


def pass_split(fn, groups: int, passes=WALK_PASSES):
    """Device microseconds per group of each of ``passes`` over two calls
    of ``fn`` (a step of ``groups`` groups or tiles), as a dict (None for a
    pass the step does not launch: the f32 walk steps' pool apply, which
    their block-end scatter holds; K1's scatter, whose every group ends a
    block), and the device microseconds per call of every kernel it
    runs."""
    *us, total = device_us(lambda i: fn(), [0, 1],
                           tuple(k for _, k in passes) + (None,),
                           required=False, some=True)
    if total is None:
        raise AssertionError("the profiler saw no kernel of the step")
    return {name: None if t is None else t / groups
            for (name, _), t in zip(passes, us)}, total


HBM_BPS = 3.35e12  # the H100 SXM's memory rate, bytes a second
PEAK_FLOPS = {False: 67e12, True: 989e12}  # f32, bf16 products


def pass_bounds(ids, pools, R: int, d: int, es: int, bf16: bool,
                n_pairs: float, walk: bool, gen: tuple | None = None) -> dict:
    """The least device µs a group of each pass of a walk or star step
    could take: the larger of its bytes (each input read once, each output
    written once) over HBM_BPS and its operations over PEAK_FLOPS (f32, or
    bf16 where the step's products are bf16), from this step's inputs:
    ``ids`` [G, 1024] the groups' table rows by slot (-1 at a walk's
    padding positions and at star pads), ``pools`` [blocks, KP], R groups a
    pool, tables of d elements of ``es`` bytes (two for a walk step, one
    for a star step), ``n_pairs`` the step's positive pairs, ``gen`` (K4)
    the generated walks' (number, length) and the CSR's bytes.  On f32
    tables (es 4: the f32 walk steps and the star steps) the pool write is
    the block end's scatter's ("block-end scatter": its group's slot
    writes, and the pool's draws, its ids and its rows), and "scatter" the
    other groups'; every walk step and every star step on f32 tables sorts
    its pools and slots once ("chains"; a star step reads its meta too).
    Returns {pass: (µs,
    "bytes" or "operations")} under WALK_PASSES', WALK_GEN_PASSES' or
    STAR_PASSES' names."""
    import torch

    G, KP = ids.shape[0], pools.shape[1]
    real = ids >= 0
    n_real = float(real.sum())
    slot_rows = [torch.unique(ids[g][real[g]]) for g in range(G)]
    uniq = float(sum(r.numel() for r in slot_rows))
    upool = float(sum(torch.unique(p).numel() for p in pools))
    nb = pools.shape[0]
    tabs = 2 if walk else 1
    fold = es == 4
    # the staged pool as the negative pass reads it: f32 rows, or past 192
    # in the bf16 modes bf16 rows of whole slabs of 256 (NEG_WHOLE)
    pool_b = KP * (-(-d // 256) * 256 * 2 if bf16 and d > 192 else d * 4)
    rows = uniq * d * es
    out = {}
    # band (walk: walks and window draws in; dphi, dctx, dphin and nt out)
    # or star (slots and meta in; dphi, dphin and nt out); each pair a
    # score and two updates of d multiply-adds
    out["band" if walk else "star"] = (
        tabs * rows + G * 1024 * 8 + G * 1024 * (d * 4 * (3 if walk else 2)
                                                + 4),
        6.0 * d * n_pairs if walk else 3.0 * d * n_pairs)
    # the slots' rows, the pool a group, ids and nt in; dphin and dneg out;
    # three products of the real slots against the pool
    out["negative"] = (rows + G * (pool_b + 1024 * 8)
                       + G * (1024 + KP) * d * 4,
                       6.0 * n_real * KP * d)
    out["stage"] = (upool * d * es + nb * KP * 4 + nb * (pool_b + KP * d * 4),
                    0.0)

    def scatter(g, pool=None):
        """Group g's slot writes: the real slots' updates, ids and chains
        in, the rows in and out (with a pool: its ids, chains and dneg in,
        and the ctx table's rows those of the slots or the pool)."""
        n = float(real[g].sum())
        b = n * d * 4 * (3 if walk else 2) + 1024 * 4
        if fold:
            b += 12 * n  # its place in the chains
        if pool is None:
            b += 2 * slot_rows[g].numel() * d * es * tabs
        else:  # a walk's node rows, and the rows of the slots or the pool
            both = torch.unique(torch.cat([slot_rows[g], pool.long()]))
            b += (2 * slot_rows[g].numel() * d * es if walk else 0) + \
                2 * both.numel() * d * es + KP * (d * 4 + 4 + 12)
        return b

    if fold:
        ends = [g for g in range(G) if g % R == R - 1 or g == G - 1]
        out["scatter"] = (sum(scatter(g) for g in range(G)
                              if g not in ends), 0.0)
        out["block-end scatter"] = (sum(scatter(g, pools[g // R])
                                        for g in ends), 0.0)
    else:
        out["scatter"] = (sum(scatter(g) for g in range(G)), 0.0)
        out["pool apply"] = (nb * KP * (d * 4 + 4) + 2 * upool * d * es,
                             0.0)
    if walk or fold:  # the pools and the slots (a star's meta too) in,
        # their chains (3 int32 each) out
        out["chains"] = (nb * KP * 16 + G * 1024 * (16 if walk else 20),
                         0.0)
    if gen is not None:  # K4: starts, draws and the CSR in, the walks out
        n_walks, L, csr_bytes = gen
        out["gen"] = (n_walks * 4 + G * 1024 * 8 + min(
            csr_bytes, n_walks * (L - 1) * 12), 0.0)
    res = {}
    for k, (nbytes, flops) in out.items():
        if nbytes == 0:
            continue
        tb, to = nbytes / G / HBM_BPS, flops / G / PEAK_FLOPS[bf16]
        res[k] = (max(tb, to) * 1e6, "bytes" if tb >= to else "operations")
    return res


def routes_since(before=None):
    """Without ``before``, a snapshot of the walk and star wrappers'
    ``routes`` counters (steps by band or star route, ``ops/walk_sgns.py``:
    POS_ROUTES), or None for a tree whose wrappers count none; with one,
    the route each walk or star step took since it, one entry a step."""
    from come_tpu_torch.ops.star_sgns import star_sgns_step
    from come_tpu_torch.ops.walk_sgns import walk_sgns_gen_step, walk_sgns_step

    fns = (walk_sgns_step, walk_sgns_gen_step, star_sgns_step)
    if not all(hasattr(f, "routes") for f in fns):
        return None
    now = [dict(f.routes) for f in fns]
    if before is None:
        return now
    return [r for a, b in zip(now, before) for r, n in a.items()
            for _ in range(n - b[r])]


def split_text(split: dict) -> str:
    return ", ".join(f"{k} {v:.2f}" for k, v in split.items()
                     if v is not None)


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


def _pass_of(name: str, passes) -> str | None:
    for p, k in passes:
        if k in name:
            return p
    return "gen" if "walk_gen" in name else None


def _spread(xs) -> dict:
    xs = sorted(xs)
    q = lambda f: xs[min(len(xs) - 1, int(f * len(xs)))]  # noqa: E731
    return {"n": len(xs), "median": statistics.median(xs), "p10": q(0.1),
            "p90": q(0.9), "min": xs[0], "max": xs[-1]}


def timeline(fn, passes, n_steps: int = 2) -> dict:
    """One ``torch.profiler`` trace of ``n_steps`` calls of ``fn`` (after a
    warm-up), read from its exported timeline: a step is a run of
    consecutive kernels of ``passes`` (the wrapper's own kernels fall
    between steps).  Returns the gaps between consecutive kernels of a
    step in µs (start of the next minus end of the previous: negative
    where they overlap), over all pairs and by "previous>next" pass, the
    steps' spans (first start to last end, µs), the share of each span
    that some kernel covers, and ``critical_us``: by pass, the µs a step's
    kernels of that pass add to its span (a kernel's end past the latest
    end before it), which sum to the span: under PDL a pass's device time
    also holds its wait for the kernel before it, this does not."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(4):  # as device_us: a profiler run may record nothing
        if attempt:
            time.sleep(0.5)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n_steps):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        ks = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     _pass_of(e["name"], passes)) for e in events
                    if e.get("cat") == "kernel")
        if any(k[2] for k in ks):
            break
    else:
        raise AssertionError("the profiler saw no kernel of the step")
    runs, cur = [], []
    for k in ks:
        if k[2] is None:
            if cur:
                runs.append(cur)
            cur = []
        else:
            cur.append(k)
    if cur:
        runs.append(cur)
    gaps, by_pair, spans, covered, crit = [], {}, [], [], {}
    for run in runs:
        for a, b in zip(run, run[1:]):
            g = b[0] - a[1]
            gaps.append(g)
            by_pair.setdefault(f"{a[2]}>{b[2]}", []).append(g)
        # what each pass adds to the step's span: its end past the latest
        # end before it (a kernel that waits under PDL adds only the time
        # it runs after its predecessor has ended)
        end = run[0][0]
        for s, e, p in run:
            crit[p] = crit.get(p, 0.0) + max(0.0, e - max(s, end)) / len(runs)
            end = max(end, e)
        span = max(k[1] for k in run) - run[0][0]
        union, end = 0.0, run[0][0]
        for s, e, _ in run:
            if e > end:
                union += e - max(s, end)
                end = e
        spans.append(span)
        covered.append(union / span if span > 0 else 1.0)
    return {"kernels_per_step": [len(r) for r in runs],
            "critical_us": crit,
            "gap_us": _spread(gaps) if gaps else None,
            "gap_us_by_pair": {k: _spread(v) for k, v in sorted(by_pair.items())},
            "span_us": spans, "covered": covered}


def host_times(fn, reps: int = 20) -> dict:
    """Host milliseconds per call of ``fn`` (after a warm-up, the card idle
    before each call, no synchronise inside the timed call): the whole
    call, and the share spent inside the kernel library's C entries
    (timed by wrapping each entry of ``build.SIGNATURES``)."""
    import torch

    from come_tpu_torch.ops import build

    lib = build.library()
    rec, saved = [], {}
    for name in build.SIGNATURES:
        f = getattr(lib, name)
        saved[name] = f

        def timed(*a, _f=f):
            t0 = time.perf_counter()
            r = _f(*a)
            rec.append(time.perf_counter() - t0)
            return r

        setattr(lib, name, timed)
    try:
        fn()
        torch.cuda.synchronize()
        total, c = [], []
        for _ in range(reps):
            torch.cuda.synchronize()
            rec.clear()
            t0 = time.perf_counter()
            fn()
            total.append(time.perf_counter() - t0)
            c.append(sum(rec))
        torch.cuda.synchronize()
    finally:
        for name, f in saved.items():
            setattr(lib, name, f)
    return {"call_ms": statistics.median(total) * 1e3,
            "c_entry_ms": statistics.median(c) * 1e3}


def c_entry_fit(sub, groups) -> dict:
    """The C entry's host ms per call of ``sub(g)`` (a step of g groups)
    for each g in ``groups``, and the least-squares line through them:
    ``intercept`` is the fixed cost of a call, ``slope`` its cost a
    group."""
    pts = [(g, host_times(sub(g), reps=10)["c_entry_ms"]) for g in groups]
    n = len(pts)
    mx = sum(g for g, _ in pts) / n
    my = sum(t for _, t in pts) / n
    slope = (sum((g - mx) * (t - my) for g, t in pts)
             / sum((g - mx) ** 2 for g, _ in pts))
    return {"points": pts, "intercept_ms": my - slope * mx,
            "slope_ms": slope}


def alloc_us(dev, KP: int, d: int, reps: int = 50) -> float:
    """Host µs to allocate one step's six scratch buffers as a wrapper
    allocating them per call does (stats zeroed, the rest empty)."""
    import torch

    f32 = torch.float32
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        bufs = [torch.zeros(2, dtype=torch.float64, device=dev),
                torch.empty((KP, d), dtype=f32, device=dev),
                torch.empty((KP, d), dtype=f32, device=dev),
                torch.empty((2, 1024, d), dtype=f32, device=dev),
                torch.empty((1024, d), dtype=f32, device=dev),
                torch.empty((1024,), dtype=f32, device=dev)]
        ts.append(time.perf_counter() - t0)
        del bufs
    return statistics.median(ts) * 1e6


def chained_ms(fn, n: int = 10, reps: int = 3) -> float:
    """CUDA-event milliseconds per call of ``fn()`` over ``n`` calls in a
    row (median of ``reps`` chains, after one warm-up): the steady state of
    a training loop, whose host enqueues the next step while the card runs
    this one.  :func:`cuda_ms` times one call from an idle card, so it
    includes the host's time to enqueue it (with graphs, to record the
    whole step) before the first kernel starts."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def replay_ms(fn, n: int = 10) -> float | None:
    """CUDA-event milliseconds per launch of ``n`` launches in a row of the
    graph that one call of ``fn()`` recorded into its launch plan
    (``ops/launch_plan.py``), without recording or updating it again: a
    step's time on the card with no host work.  None where ``fn`` runs
    through no plan."""
    import torch

    from come_tpu_torch.ops import build, launch_plan

    before = {id(p): p.replays for p in launch_plan.plans()}
    fn()
    ran = [p for p in launch_plan.plans()
           if getattr(p, "slot", None) and p.replays != before.get(id(p))]
    # a scan's WHILE graph needs its entry kernel before every launch
    if len(ran) != 1 or isinstance(ran[0], launch_plan.ScanPlan):
        return None
    lib, slot = build.library(), ran[0].slot
    stream = torch.cuda.current_stream().cuda_stream
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(3):
        a.record()
        for _ in range(n):
            build.check(lib.come_step_graph_launch(slot, stream),
                        "come_step_graph_launch")
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def enqueue_ms(fn, n: int = 10) -> float:
    """Host milliseconds per call of ``fn()`` over ``n`` calls in a row,
    without a synchronise between them (after a warm-up, from an idle
    card).  Below :func:`chained_ms` the host enqueued ahead of the card:
    no call waited for the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t * 1e3 / n


SCAN_MICRO = 8  # micro-steps in the scan steps' macro batch

# the steps whose negative pass takes bf16 products, and the slots of a
# group or tile of each step's pass (the karate steps' tiles are 64 pairs)
BF16_PASS = ("K1b bench", "K4 bench", "K2b bench", "K3")


def pass_slots(name: str) -> int:
    return 64 if "karate" in name else 1024


def library3_ms(dev, slots: int, KP: int, d: int, bf16: bool,
                n: int = 10) -> float:
    """Device ms (:func:`device_us`: the calls' kernels, not the host's
    launches between them) of one group's negative pass as three PyTorch
    matrix products on ``[slots, d]`` rows against a ``[KP, d]`` pool: S =
    Phi C^T, G = sigmoid(S), dphi = G C and dneg = G^T Phi (f32 with TF32
    off; with ``bf16`` the operands bf16 and every product's output f32),
    over ``n`` calls.  A yardstick: the port never calls it."""
    import torch

    g = torch.Generator(device=dev).manual_seed(0)
    phi = torch.randn((slots, d), generator=g, device=dev) * 0.1
    c = torch.randn((KP, d), generator=g, device=dev) * 0.1
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if bf16:
            pb, cb = phi.bfloat16(), c.bfloat16()

            def run():
                s = torch.mm(pb, cb.t(), out_dtype=torch.float32)
                gb = torch.sigmoid(s).bfloat16()
                torch.mm(gb, cb, out_dtype=torch.float32)
                torch.mm(gb.t(), pb, out_dtype=torch.float32)
        else:
            def run():
                gs = torch.sigmoid(phi @ c.t())
                gs @ c
                gs.t() @ phi
        return device_us(lambda i: run(), list(range(n))) / 1e3
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def library_us(dev, d: int, ids, pools, R: int, es: int, walk: bool,
               wide_bf16: bool = False, n: int = 10) -> dict:
    """Device µs a group (:func:`device_us`: the calls' kernels) of one
    PyTorch call that does each of three passes' work at a step's shapes
    (``ids``, ``pools``, R, es and walk as :func:`pass_bounds` takes them;
    a [V, d] table of es-byte elements, V past the largest id): "stage"
    index_select of a pool's rows, cast to the dtype the stage writes
    where the table's differs (f32 rows, or bf16 rows with ``wide_bf16``:
    the bf16 passes' stage past d 192), once a block; "pool apply" index_add_ of a
    pool's [KP, d] update into the table, once a block; "scatter"
    index_add_ of a group's real slots' [n, d] updates, once for each table
    the pass writes (two for a walk step); on f32 tables (the f32 walk
    steps and the star steps), whose block ends write the pool in their
    scatter, "scatter" the groups that end no block and "block-end scatter"
    the others, with the pool's index_add_.
    Each over ``n`` calls; with "calls", the calls by name.  A yardstick:
    the port never calls them."""
    import torch

    dtype = torch.bfloat16 if es == 2 else torch.float32
    V = int(max(int(ids.max()), int(pools.max()))) + 1
    g = torch.Generator(device=dev).manual_seed(0)
    tab = (torch.randn((V, d), generator=g, device=dev) * 0.1).to(dtype)
    G, KP, blocks = ids.shape[0], pools.shape[1], pools.shape[0]
    pool = pools[0].long()
    slots = ids[0][ids[0] >= 0].long()
    upd_p = torch.randn((KP, d), generator=g, device=dev).to(dtype) * 1e-3
    upd_s = torch.randn((slots.numel(), d), generator=g, device=dev).to(
        dtype) * 1e-3
    out = torch.bfloat16 if wide_bf16 else torch.float32
    cast = dtype != out

    def stage():
        rows = tab.index_select(0, pool)
        return rows.to(out) if cast else rows

    tabs = 2 if walk else 1
    apply = device_us(lambda i: tab.index_add_(0, pool, upd_p),
                      list(range(n)))
    scatter = device_us(lambda i: tab.index_add_(0, slots, upd_s),
                        list(range(n))) * tabs
    us = {"stage": device_us(lambda i: stage(), list(range(n))) * blocks / G}
    calls = {"stage": "index_select" + (f" + .to({str(out)[6:]})" if cast
                                        else "")}
    if es == 4:  # the f32 walk and star steps' pool write: the block end's
        us["scatter"] = scatter * (G - blocks) / G
        us["block-end scatter"] = (scatter + apply) * blocks / G
        calls["scatter"] = f"index_add_ x {tabs}"
        calls["block-end scatter"] = f"index_add_ x {tabs + 1}"
    else:
        us["pool apply"] = apply * blocks / G
        us["scatter"] = scatter
        calls["pool apply"] = "index_add_"
        calls["scatter"] = f"index_add_ x {tabs}"
    us["calls"] = calls
    return us


def _scan_step(scan, step, tables, c, x, pools, m, lr, negw, TP):
    """A macro batch as one scan call, with ``.loop``: the same micro-steps
    as one ``step`` call each, and ``.micro``: their number."""
    def run():
        scan(*tables, c, x, pools, m, lr, negw, tile_pairs=TP)

    def loop():
        for i in range(c.shape[0]):
            step(*tables, c[i], x[i], pools[i], m[i], lr, negw, tile_pairs=TP)

    run.loop, run.micro = loop, c.shape[0]
    return run


def steps(dev, d: int = 128):
    """(name, step(), groups or tiles, passes, sub, KP) at chip_smoke.py's
    shapes, the tables d wide (karate's K6/K7 keep 16); each step updates
    its own tables in place.  ``sub(g)`` is the step cut to its first g
    groups (K1 and K2; None for the others)."""
    import numpy as np
    import torch

    from come_tpu_torch.graphs import get_dataset
    from come_tpu_torch.ops.sgns import (
        fused_sgns_scan,
        fused_sgns_step,
        fused_sgns_step_tied,
    )
    from come_tpu_torch.ops.star_sgns import star_sgns_step
    from come_tpu_torch.ops.walk_sgns import (
        walk_sgns_gen_step,
        walk_sgns_step,
        walks_from_bits,
    )
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
    V, B, L, W, KP = ds.graph.num_nodes, 256, 80, 10, 512
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
    def k1_sub(g):
        return lambda: walk_sgns_step(emb_in, emb_out, walks[:8 * g],
                                      wrow[:g * 1024], pools[:g], lr, negw,
                                      window=W, pool_refresh=1)

    def walk_ids(w):  # [G, 1024] rows by slot, -1 past the walk length
        ids = torch.full((w.shape[0], 128), -1, dtype=torch.int64,
                         device=dev)
        ids[:, :w.shape[1]] = w
        return ids.reshape(-1, 1024)

    def star_ids(sl_, mt_):
        return torch.where(mt_ >= 0, sl_.long(), -1).reshape(-1, 1024)

    k1 = k1_sub(G)
    k1.bounds = (walk_ids(walks), pools, 1, 4, False, True)
    out = [("K1", k1, G, WALK_PASSES, k1_sub, KP)]

    # the bench path's O1 step: 2048 walks, alias pools, R 8, bf16 (drawn
    # from a generator of its own, so the other steps' inputs stay as
    # they were)
    accept, alias = (torch.as_tensor(a, device=dev) for a in
                     build_alias_table(unigram_weights(ds.graph.degrees)))
    BB, RB = 2048, 8
    GB = BB // 8
    gb = torch.Generator(device=dev).manual_seed(1)
    walks_b = random_walks(csr, torch.randint(0, V, (BB,), generator=gb,
                                              device=dev), L, gb)
    wrow_b = torch.randint(1, W + 1, (GB * 1024,), generator=gb, device=dev,
                           dtype=torch.int32)
    pools_1b = sample_alias(accept, alias, gb, (-(-GB // RB), KP))
    k1b = lambda: walk_sgns_step(  # noqa: E731
        emb_in, emb_out, walks_b, wrow_b, pools_1b, lr, negw, window=W,
        pool_refresh=RB, mxu_bf16=True)
    k1b.bounds = (walk_ids(walks_b), pools_1b, RB, 4, True, True)
    out.append(("K1b bench", k1b, GB, WALK_PASSES, None, KP))

    # the bench path's O1 step with its walks generated on the card (K4):
    # K1b bench's shapes, window draws and pools, the starts and 32-bit
    # draws from a generator of their own; its walk generation is a pass
    # of its own ("gen")
    gk = torch.Generator(device=dev).manual_seed(2)
    starts_k = torch.randint(0, V, (BB,), generator=gk, device=dev)
    bits_k = torch.randint(-2 ** 31, 2 ** 31, (GB * 1024,), generator=gk,
                           device=dev, dtype=torch.int32)
    k4 = lambda: walk_sgns_gen_step(  # noqa: E731
        emb_in, emb_out, starts_k, bits_k, csr.indptr, csr.indices, wrow_b,
        pools_1b, lr, negw, walk_length=L, window=W, pool_refresh=RB,
        mxu_bf16=True)
    walks_k = walks_from_bits(starts_k, bits_k, csr.indptr, csr.indices, L)
    k4.bounds = (walk_ids(walks_k), pools_1b, RB, 4, True, True)
    k4.gen = (BB, L, 4 * (csr.indptr.numel() + csr.indices.numel()))
    out.append(("K4 bench", k4, GB, WALK_GEN_PASSES, None, KP))

    u, v = ds.graph.edges_undirected()
    slots, meta = build_star_layout(u, v, V)
    lay_s, lay_m = slots.reshape(-1, 128), meta.reshape(-1, 128)
    perm = np.random.default_rng(0).permutation(lay_s.shape[0])[:512]
    sl = torch.as_tensor(lay_s[perm], device=dev).reshape(-1)
    mt = torch.as_tensor(lay_m[perm], device=dev).reshape(-1)
    G2 = sl.numel() // 1024
    pools2 = torch.randint(0, V, (G2, KP), generator=gen, device=dev,
                           dtype=torch.int32)
    def k2_sub(g):
        return lambda: star_sgns_step(emb_in, sl[:g * 1024], mt[:g * 1024],
                                      pools2[:g], lr, negw, pool_refresh=1)

    k2 = k2_sub(G2)
    k2.bounds = (star_ids(sl, mt), pools2, 1, 4, False, False)
    out.append(("K2", k2, G2, STAR_PASSES, k2_sub, KP))

    # the bench path's star step: the whole layout in ceil(NR / 8) * 8
    # rows, alias pools, R 8, bf16
    NR = lay_s.shape[0]
    rps = -(-NR // 8) * 8
    rperm = np.random.default_rng(0).permutation(NR)
    sl_b = torch.as_tensor(np.pad(lay_s[rperm], ((0, rps - NR), (0, 0))),
                           device=dev).reshape(-1)
    mt_b = torch.as_tensor(np.pad(lay_m[rperm], ((0, rps - NR), (0, 0)),
                                  constant_values=PAD_META),
                           device=dev).reshape(-1)
    G2B = rps * 128 // 1024
    pools_b = sample_alias(accept, alias, gen, (-(-G2B // RB), KP))
    k2b = lambda: star_sgns_step(  # noqa: E731
        emb_in, sl_b, mt_b, pools_b, lr, negw, pool_refresh=RB,
        mxu_bf16=True)
    k2b.bounds = (star_ids(sl_b, mt_b), pools_b, RB, 4, True, False)
    out.append(("K2b bench", k2b, G2B, STAR_PASSES, None, KP))

    eperm = torch.as_tensor(np.random.default_rng(0).permutation(
        u.shape[0])[:512 * 64], device=dev)
    uu, vv = (torch.as_tensor(a, device=dev)[eperm] for a in (u, v))
    rows = torch.stack([uu, vv], 1).reshape(512, 128)
    pools5 = torch.randint(0, V, (64, KP), generator=gen, device=dev,
                           dtype=torch.int32)
    k5 = lambda: walk_sgns_step(  # noqa: E731
        emb_in, emb_out, rows, None, pools5, lr, negw, window=1,
        pool_refresh=1, paired=True)
    k5.bounds = (walk_ids(rows), pools5, 1, 4, False, True)
    out.append(("K5", k5, 64, WALK_PASSES, None, KP))

    keep = torch.as_tensor(subsample_keep_probs(ds.graph.degrees, 1e-3),
                           device=dev)
    c, x, m = (a.reshape(-1)[:32768] for a in
               skipgram_pairs(walks, W, gen, keep))
    pool = sample_alias(accept, alias, gen, (KP,))
    out.append(("K6", lambda: fused_sgns_step(emb_in, emb_out, c, x, pool, m,
                                              lr, negw, tile_pairs=1024),
                32, FUSED_PASSES, None, KP))
    src, dst = (torch.as_tensor(a, device=dev) for a in ds.graph.arcs())
    arcs = torch.randperm(src.numel(), generator=gen, device=dev)[:32768]
    ones = torch.ones(arcs.numel(), device=dev)
    out.append(("K7", lambda: fused_sgns_step_tied(
        emb_in, src[arcs], dst[arcs], pool, ones, lr, negw, tile_pairs=1024),
        32, FUSED_PASSES, None, KP))

    # K6/K7 at karate's shared-negative shapes (chip_smoke.py phase 9: d 16,
    # micro-steps of batch_pairs 128 in tiles of 64, pools of 32)
    Vk, dk, Pk, TPk, KPk = get_dataset("karate").graph.num_nodes, 16, 128, \
        64, 32
    tk = [torch.randn((Vk, dk), generator=gen, device=dev) * 0.1
          for _ in range(2)]
    ck, xk = (torch.randint(0, Vk, (Pk,), generator=gen, device=dev)
              for _ in range(2))
    mk = (torch.rand(Pk, generator=gen, device=dev) < 0.8).float()
    pk = torch.randint(0, Vk, (KPk,), generator=gen, device=dev)
    out.append(("K6 karate", lambda: fused_sgns_step(
        *tk, ck, xk, pk, mk, lr, 5.0 / KPk, tile_pairs=TPk), 2, FUSED_PASSES,
        None, KPk))
    out.append(("K7 karate", lambda: fused_sgns_step_tied(
        tk[0], ck, xk, pk, mk, lr, 5.0 / KPk, tile_pairs=TPk), 2,
        FUSED_PASSES, None, KPk))

    # a macro batch of SCAN_MICRO K6 micro-steps as one scan (one launch of
    # its WHILE graph), at K6's and at karate's shapes; the step's `loop`
    # runs the same micro-steps one call each
    n = SCAN_MICRO
    cs, xs, ms_ = (a.reshape(-1)[:n * 32768].reshape(n, 32768) for a in
                   skipgram_pairs(walks.repeat(2, 1), W, gen, keep))
    pools_s = sample_alias(accept, alias, gen, (n, KP))
    scan = _scan_step(fused_sgns_scan, fused_sgns_step, (emb_in, emb_out),
                      cs, xs, pools_s, ms_, lr, negw, 1024)
    out.append(("K6 scan", scan, n * 32, FUSED_PASSES, None, KP))
    cks, xks = (torch.randint(0, Vk, (n, Pk), generator=gen, device=dev)
                for _ in range(2))
    mks = (torch.rand((n, Pk), generator=gen, device=dev) < 0.8).float()
    pks = torch.randint(0, Vk, (n, KPk), generator=gen, device=dev)
    scan_k = _scan_step(fused_sgns_scan, fused_sgns_step, tuple(tk), cks, xks,
                        pks, mks, lr, 5.0 / KPk, TPk)
    out.append(("K6 karate scan", scan_k, n * 2, FUSED_PASSES, None, KPk))

    # K3 at the synthetic-10m shapes on bf16 tables; its walks are drawn
    # uniformly over V (a step's cost needs the shapes, not the graph)
    V3, B3, KP3 = 500_000, 1024, 2048
    G3 = B3 // 8
    tabs3 = [(torch.randn((V3, d), generator=gen, device=dev) * 0.1).to(
        torch.bfloat16) for _ in range(2)]
    walks3 = torch.randint(0, V3, (B3, L), generator=gen, device=dev)
    wrow3 = torch.randint(1, W + 1, (G3 * 1024,), generator=gen, device=dev,
                          dtype=torch.int32)
    pools3 = torch.randint(0, V3, (G3, KP3), generator=gen, device=dev,
                           dtype=torch.int32)
    k3 = lambda: walk_sgns_step(  # noqa: E731
        *tabs3, walks3, wrow3, pools3, lr, 5.0 / KP3, window=W,
        pool_refresh=1, sr_seed=7)
    k3.bounds = (walk_ids(walks3), pools3, 1, 2, True, True)
    out.append(("K3", k3, G3, WALK_PASSES, None, KP3))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                   help="the checkout whose come_tpu_torch to time")
    p.add_argument("--label", default="", help="a name for the JSON lines")
    p.add_argument("--steps", nargs="*", default=None,
                   help="the steps to time (default: all)")
    p.add_argument("--trace", action="store_true",
                   help="add the timeline's gaps and the host's enqueue time")
    p.add_argument("--run", type=int, default=10,
                   help="steps in a row for chained_ms (default 10)")
    p.add_argument("--dim", type=int, default=128,
                   help="the tables' width (default 128)")
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
    todo = [s for s in steps(dev, args.dim)
            if args.steps is None or s[0] in args.steps]
    # every step's times first: once a profiler session has run, the host's
    # CUDA calls are slower, which shows in a step whose host work outlasts
    # its device work
    pre = {}
    for name, step, groups, passes, sub, KP in todo:
        t = pre[name] = {"ms": cuda_ms(step),
                         "chained_ms": chained_ms(step, n=args.run),
                         "replay_ms": replay_ms(step, n=args.run)}
        if hasattr(step, "loop"):  # a scan: per micro-step, scan and loop
            k = step.micro
            t["per_micro_ms"] = {
                "scan_from_idle": t["ms"] / k,
                "scan": t["chained_ms"] / k,
                "loop": chained_ms(step.loop, n=max(1, args.run // k)) / k}
        if args.trace:
            h = t["host"] = host_times(step)
            h["enqueue_ms"] = enqueue_ms(step, n=args.run)
            h["alloc_us"] = alloc_us(dev, KP, args.dim)
            if sub is not None:
                h["c_entry_fit"] = c_entry_fit(
                    sub, [g for g in (1, 2, 4, 8, 16, 32, 64) if g <= groups])
    for name, step, groups, passes, sub, KP in todo:
        t = pre[name]
        # the route and the pairs are read from pass_split's own calls, so
        # a tree whose wrappers count no routes runs the same sequence
        before, out = routes_since(), []
        split, total = pass_split(lambda: out.append(step()), groups, passes)
        # a walk step's pools sorted into chains once a step, before its
        # groups (csrc/sgns_common.cuh: pool_chains_kernel; in another
        # tree K3's alone), and its groups' slots beside it
        # (slot_chains_kernel)
        # (a star step's: its pools' and its groups' real slots', since
        # this tree's star steps sort them too)
        chained = passes in (WALK_PASSES, WALK_GEN_PASSES, STAR_PASSES)
        chains_us = device_us(lambda i: step(), [0, 1], "pool_chains",
                              required=False) if chained else None
        slots_us = device_us(lambda i: step(), [0, 1], "slot_chains",
                             required=False) if chained else None
        taken = None if before is None else set(routes_since(before))
        route = taken.pop() if taken and len(taken) == 1 else None
        bounds = lib_us = per_launch = None
        if hasattr(step, "bounds"):  # from this step's inputs and pairs
            ids, pools, R, es, bf16, walk = step.bounds
            bounds = pass_bounds(ids, pools, R, args.dim, es, bf16,
                                 float(out[-1][-1]), walk,
                                 getattr(step, "gen", None))
            lib_us = library_us(dev, args.dim, ids, pools, R, es, walk,
                                bf16 and args.dim > 192)
            # the f32 slot writes a launch: the groups that end no block,
            # and the block ends' (their pool write folded in)
            nb = pools.shape[0]
            per_launch = {
                p: split[p] * groups / n for p, n in (
                    ("scatter", groups - nb), ("block-end scatter", nb))
                if split.get(p) is not None and n > 0} if es == 4 else None
        del out
        line = {
            "card": card, "label": args.label,
            "package": str(Path(come_tpu_torch.__file__).parent),
            "step": name, "dim": args.dim, "groups": groups, "ms": t["ms"],
            "run": args.run, "chained_ms": t["chained_ms"],
            "replay_ms": t["replay_ms"],
            # row 1b's reading: what a step in a run and one from an idle
            # card cost beyond the replay of its recording
            "run_minus_replay_ms": (None if t["replay_ms"] is None else
                                    t["chained_ms"] - t["replay_ms"]),
            "idle_minus_replay_ms": (None if t["replay_ms"] is None else
                                     t["ms"] - t["replay_ms"]),
            "per_micro_ms": t.get("per_micro_ms"), "us_per_group": split,
            # the band or star pass's route, and each pass's least µs a
            # group with what bounds it (pass_bounds)
            "route": route, "bound_us_per_group": bounds,
            # one PyTorch call a pass for the stage, pool apply and
            # scatter (library_us)
            "library_us_per_group": lib_us,
            "scatter_us_per_launch": per_launch,
            "pool_chains_us_per_step": chains_us,
            "slot_chains_us_per_step": slots_us,
            "library3_ms": library3_ms(dev, pass_slots(name), KP, args.dim
                                       if "karate" not in name else 16,
                                       name in BF16_PASS),
            "device_us_per_group": total / groups,
            "busy": total / (t["ms"] * 1e3),
        }
        if args.trace:
            line["timeline"] = timeline(step, passes)
            line["critical_us_per_group"] = {
                p: v / groups for p, v in
                line["timeline"]["critical_us"].items()}
            line["host"] = t["host"]
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
