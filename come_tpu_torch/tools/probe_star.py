"""P3 on the card: what each section of the star kernel's group costs.

    python -m come_tpu_torch.tools.probe_star [--dim D]

The counterpart of ``scripts/probe_star.py:234-281``.  On the BlogCatalog
stand-in's star layout (``sampling.stars.build_star_layout``), cut to whole
groups of 1024 slots, with a table and one pool drawn from
``np.random.default_rng(0)`` (V 10312, d 128, KP 512, R 8, lr 0.01, negw
5 / KP), it runs ``ops/star_probe.py``'s kernel with every section on, with
one section off at a time, with single sections, with none, and with 8, 16,
64 and 128 rows in flight per warp in the gather and scatter, and prints µs
per group for each: CUDA events, after one warm-up, the median of 3 samples
of 4 chained steps.  ``--dim`` (``run(d=...)``) makes the table that wide
(a multiple of 4; past 192 the probe's MATH section runs K2b's column-slab
passes).  Beside them it prints K2b's own µs per group
(``ops/star_sgns.py`` with ``mxu_bf16``) at the same inputs, and the device
time per group of each kernel of the full variant under ``torch.profiler``.

Before timing, the full variant is held against K2b's plain version under
``ops/tolerance.py``'s bf16 check (loss rtol 1e-4, pair counts exact), and
every variant against its own plain version: the bf16 check's error rules
where the plain step moves the table, the table bit for bit where it does
not; loss rtol 1e-4, pair counts exact.  Needs a CUDA card; about 15 s.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

D, KP, R, LR = 128, 512, 8, 0.01
# (label, sections switched off), as scripts/probe_star.py:264-279
VARIANTS = (
    ("full", {}),
    ("no scatter", dict(scatter=False)),
    ("no gather", dict(gather=False)),
    ("no math (g+s only)", dict(math=False)),
    ("no neg pass", dict(neg=False)),
    ("no pool", dict(pool=False)),
    ("math only", dict(gather=False, scatter=False, pool=False)),
    ("gather only", dict(math=False, scatter=False, pool=False)),
    ("scatter only", dict(math=False, gather=False, pool=False)),
    ("empty", dict(math=False, gather=False, scatter=False, pool=False)),
)
UNROLL_SWEEP = (8, 16, 64, 128)


def chained_us(step, groups: int, samples: int = 3, chain: int = 4) -> float:
    """µs per group of ``step()``: one warm-up call, then the median of
    ``samples`` CUDA-event timings of ``chain`` calls in a row."""
    step()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(chain):
            step()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) * 1e3 / (chain * groups))
    return statistics.median(times)


def inputs(device, d: int = D):
    """(emb0, slots, meta, sneg, G) on ``device``: probe_star.py:238-248
    on the port's dataset and layout, the table d wide."""
    from come_tpu_torch.graphs import get_dataset
    from come_tpu_torch.ops.star_sgns import NWL
    from come_tpu_torch.sampling.stars import build_star_layout

    ds = get_dataset("blogcatalog")
    u, v = ds.graph.edges_undirected()
    V = ds.graph.num_nodes
    slots, meta = build_star_layout(u, v, V)
    T = slots.shape[0] // NWL * NWL
    rng = np.random.default_rng(0)
    emb0 = rng.normal(size=(V, d)).astype(np.float32) * 0.1
    sneg = rng.integers(0, V, KP).astype(np.int32)
    dev = torch.device(device)
    return (torch.as_tensor(emb0, device=dev),
            torch.as_tensor(slots[:T], device=dev),
            torch.as_tensor(meta[:T], device=dev),
            torch.as_tensor(sneg, device=dev), T // NWL)


def check_step(name, init, kern, plain, f32=None):
    """Hold a probe step ``kern`` = (emb, loss, pairs) against ``plain``:
    with ``f32`` (the plain f32 step) the full bf16 check, returning its
    (max abs error, relative L2 error, f32-vs-bf16 distance, worst element
    error over its limit); else its error rules where the plain step moves
    the table, bit for bit where it does not, returning the max abs error.
    Loss rtol 1e-4, pairs exact."""
    from come_tpu_torch.ops.tolerance import (
        BF16_L2,
        bf16_update_errors,
        check_bf16,
    )

    if float(kern[2]) != float(plain[2]) or abs(
            float(kern[1]) - float(plain[1])) > 1e-4 * abs(float(plain[1])):
        raise AssertionError(f"P3 {name}: loss {float(kern[1])} vs "
                             f"{float(plain[1])}, pairs {float(kern[2])} vs "
                             f"{float(plain[2])}")
    if not torch.isfinite(kern[0]).all():
        raise AssertionError(f"P3 {name}: non-finite table")
    if f32 is not None:
        return check_bf16(f"P3 {name}", (init,), (kern[0],), (plain[0],),
                          (f32[0],))
    if torch.equal(plain[0], init):
        if not torch.equal(kern[0], init):
            raise AssertionError(f"P3 {name}: the table moved")
        return 0.0
    l2, worst, max_abs = bf16_update_errors((init,), (kern[0],), (plain[0],))
    if l2 > BF16_L2 or worst > 1.0:
        raise AssertionError(f"P3 {name}: relative L2 {l2:.3e}, worst "
                             f"element {worst:.2f} of 2^-8 max|update|")
    return max_abs


def run(device="cuda", log=print, d: int = D) -> dict:
    """Check and time every variant on ``device`` (a CUDA card) with the
    table d wide; returns the readings (µs per group by variant and
    unroll, K2b's, the profile, the full variant's error, ms per step and
    the plain version's)."""
    from come_tpu_torch.ops.star_probe import (
        star_probe_step,
        star_probe_step_reference,
    )
    from come_tpu_torch.ops.star_sgns import (
        star_sgns_step,
        star_sgns_step_reference,
    )

    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"probe_star times a CUDA card, not {dev}")
    emb0, slots, meta, sneg, G = inputs(dev, d)
    negw = 5.0 / KP
    args = (slots, meta, sneg, LR, negw)

    def probe(fn, e, **kw):
        return fn(e, *args, pool_refresh=R, **kw)

    # the full variant against K2b's plain version, then every variant
    # against its own plain version
    k2b_plain = probe(star_sgns_step_reference, emb0.clone(), mxu_bf16=True)
    f32 = probe(star_sgns_step_reference, emb0.clone())
    full = probe(star_probe_step, emb0.clone())
    torch.cuda.synchronize()
    err = check_step("full vs K2b's plain version", emb0, full, k2b_plain,
                     f32)
    pairs = float(full[2])
    del k2b_plain, f32
    for label, off in VARIANTS:
        check_step(label, emb0, probe(star_probe_step, emb0.clone(), **off),
                   probe(star_probe_step_reference, emb0.clone(), **off))

    def timed(fn, **kw):
        e = emb0.clone()
        return chained_us(lambda: probe(fn, e, **kw), G)

    rows = [(label, timed(star_probe_step, **off)) for label, off in VARIANTS]
    unroll = [(u, timed(star_probe_step, unroll=u)) for u in UNROLL_SWEEP]
    k2b_us = timed(star_sgns_step, mxu_bf16=True)
    e = emb0.clone()
    plain_ms = chained_us(lambda: probe(star_probe_step_reference, e), 1, 3, 1)
    plain_ms /= 1e3
    profile = kernel_profile(lambda: probe(star_probe_step, emb0.clone()), G)

    log(f"P3 groups={G} slots={G * 1024} V={emb0.shape[0]} d={d} KP={KP} "
        f"R={R} (us/group, median of 3 samples of 4 chained steps)")
    for label, us in rows:
        log(f"{label:20s} {us:9.2f}")
    for u, us in unroll:
        log(f"full unroll={u:<3d}      {us:9.2f}")
    log(f"K2b (star_sgns_step, mxu_bf16) {k2b_us:9.2f}")
    log("full variant by kernel (profiler, us/group): " + ", ".join(
        f"{k} {v:.2f}" for k, v in profile.items()))
    log(f"full variant vs K2b's plain version: max_abs {err[0]:.3e} "
        f"rel_l2 {err[1]:.3e} (f32-vs-bf16 distance {err[2]:.3e}; worst "
        f"element {err[3]:.3f} of 2^-8 max|plain update|), pairs "
        f"{pairs:.0f}")
    return {"G": G, "rows": dict(rows), "unroll": dict(unroll),
            "k2b_us": k2b_us, "profile": profile, "max_abs_err": err[0],
            "pairs": pairs, "ms": dict(rows)["full"] * G / 1e3,
            "plain_ms": plain_ms, "inputs": (slots, meta, sneg)}


def kernel_profile(step, groups: int) -> dict:
    """Device µs per group of each kernel of one ``step()`` call
    (``torch.profiler``, CUDA activity), keyed by the kernel's name."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = ev.device_time_total
        if t > 0:
            name = ev.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].split("::")[-1].strip()
            out[name] = out.get(name, 0.0) + t / groups
    if not out:
        raise AssertionError("the profiler saw no CUDA kernel")
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dim", type=int, default=D,
                   help=f"the table's width (default {D})")
    run(d=p.parse_args(argv).dim)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
