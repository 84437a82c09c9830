"""The check that holds a kernel's bf16 mode against its plain version.

In the bf16 modes (``mxu_bf16``: K1b, K2b, and K4/K5 with it) every product
operand is rounded to bf16, and a product of two bf16 values is exact in
f32, so two implementations differ only in the order of their f32 sums.
Where two orders straddle a rounding boundary, a rounded g flips by one
bf16 ulp, 2^-8 of itself.  Groups run in order and each reads what the
groups before it wrote, so an early flip moves later reads: flips compound
over a step's groups, and the error grows with the number of groups.  The
check is on the table updates (after the step minus before):

  * relative L2 error <= ``BF16_L2`` = 4e-4, set from readings at the
    longest steps the port runs, the reference bench's: one O1 step of 2048
    walks (256 groups, R 8) and one star O2 step of 344 groups (R 8).  A
    float64 emulation of the plain version reads 1.4-1.6e-4 (O1) and
    1.7-2.1e-4 (star) there over several seeds, against 2.6e-5 for 32
    groups at R 1; the kernels on an H100 read 1.30e-4 (K1b), 1.41e-4 (K4)
    and 1.19e-4 (K2b);
  * every element within 2^-8 of the largest plain update, one bf16 ulp of
    it (the emulation's readings: at most 0.19 of that);
  * the f32 plain step lies at least ``BF16_APART`` = 5x farther from the
    bf16 plain step than the kernel does, and at least 2x the bound, so the
    check tells a bf16 pass from an f32 one, in the kernel and in the plain
    version.  At the bench's O1 shapes that distance is 1.35-1.75e-3 (3.4-
    4.4x the bound): a bound 5x below it would sit 1.7x above the readings.

Where only part of a step rounds (K5 with ``mxu_bf16`` rounds only its
negative pass), the callers take the updates past the same step with that
part off (negw = 0), so the distance measures the part that rounds.

K3 (bf16 tables) writes every touched element through a rounding to bf16
with the same random bits in the kernel and its plain version, so the two
agree bit for bit except where their f32 sums straddle a rounding point;
there the element moves by one bf16 ulp of the VALUE, which can exceed the
update itself.  :func:`check_k3` holds the kernel's step to:

  * at least ``K3_IDENTICAL`` = 99% of the elements of touched rows
    bit-identical (a wrong rounding rule flips about half of them);
  * relative L2 error of the updates <= ``K3_L2`` = 5e-3.  It was set
    from an emulation of two departures, another order of the f32 sums
    and another order of a row's repeated writes within a group (2.40-2.52e-3
    at chip_smoke's K3 shapes, 3.05e-3 at the card tests' V 20000 and
    50000).  The kernel now writes a group's rows in slot order, as the
    plain version and the TPU do, so :func:`emulate_k3` emulates only the
    sums: float64 against the plain version's f32.  At chip_smoke's K3
    shapes (128 groups on the synthetic-10m graph, where 2.6% of a group's
    slots repeat a row of their walk) it reads, over seeds 0-2,
    2.12-2.31e-4 with stochastic rounding and 2.23-2.74e-4 truncating, with
    0.99998 of touched elements bit-identical;
  * the f32-table step on the same inputs (K1b, whose writes are not
    rounded) at least ``BF16_APART`` = 5x farther from the plain K3 step
    (the emulation: 8.25-8.30e-2 with SR, 1.395e-1 truncating, 357-626x
    the error and 16x the bound).

Run ``python -m come_tpu_torch.ops.tolerance`` for the emulation's readings.
"""

from __future__ import annotations

import argparse

import torch

BF16_L2 = 4e-4  # relative L2 error of the updates
BF16_ELEM = 2.0 ** -8  # per element, of the largest plain update
BF16_APART = 5.0  # f32-vs-bf16 distance over the kernel's error


def bf16_update_errors(init, got, want):
    """(relative L2 error, worst element error over ``BF16_ELEM`` *
    max|want - init|, max abs element error) of the table updates
    ``got - init`` against ``want - init``; each argument a sequence of
    [V, d] tables (tensors or arrays), accumulated in float64."""
    num = den = max_abs = max_upd = 0.0
    for t0, a, b in zip(init, got, want):
        t0 = torch.as_tensor(t0).double()
        du = torch.as_tensor(b).double().to(t0.device) - t0
        err = torch.as_tensor(a).double().to(t0.device) - t0 - du
        num += float((err ** 2).sum())
        den += float((du ** 2).sum())
        max_abs = max(max_abs, float(err.abs().max()))
        max_upd = max(max_upd, float(du.abs().max()))
    return (num / den) ** 0.5, max_abs / (BF16_ELEM * max_upd), max_abs


def check_bf16(name: str, init, got, want, f32):
    """Hold ``got`` (a kernel's bf16 step from the tables ``init``) against
    ``want`` (the plain version's bf16 step) and ``f32`` (its f32 step) by
    the rules above; raises AssertionError past them.  Returns (max abs
    element error, relative L2 error, f32-vs-bf16 distance, worst element
    error over its limit)."""
    want = list(want)
    l2, worst, max_abs = bf16_update_errors(init, got, want)
    dist, _, _ = bf16_update_errors(init, f32, want)
    if worst > 1.0:
        raise AssertionError(f"{name}: an update error is {worst:.2f}x "
                             f"2^-8 * max|plain update|")
    if l2 > BF16_L2:
        raise AssertionError(f"{name}: relative L2 error {l2:.3e} > "
                             f"{BF16_L2}")
    if dist < BF16_APART * l2 or dist < 2 * BF16_L2:
        raise AssertionError(
            f"{name}: the f32 step lies {dist:.3e} from the bf16 step, not "
            f"{BF16_APART}x the error {l2:.3e} and 2x the bound {BF16_L2}")
    return max_abs, l2, dist, worst


K3_IDENTICAL = 0.99  # share of touched rows' elements bit-identical
K3_L2 = 5e-3  # relative L2 error of the updates (emulate_k3)


def k3_update_errors(init, got, want):
    """(share of bit-identical elements over the rows either step touched,
    relative L2 error of the updates ``got - init`` against
    ``want - init``, max abs element error); each argument a sequence of
    [V, d] tables, ``got``/``want`` bf16 or f32."""
    same = total = 0
    num = den = max_abs = 0.0
    for t0, a, b in zip(init, got, want):
        t0 = torch.as_tensor(t0)
        a = torch.as_tensor(a).to(t0.device)
        b = torch.as_tensor(b).to(t0.device)
        rows = ((a.double() != t0.double()) | (b.double() != t0.double())
                ).any(1)
        if a.dtype == b.dtype == torch.bfloat16:
            eq = a[rows].view(torch.int16) == b[rows].view(torch.int16)
            same += int(eq.sum())
        total += int(rows.sum()) * t0.shape[1]
        du = b.double() - t0.double()
        err = a.double() - t0.double() - du
        num += float((err ** 2).sum())
        den += float((du ** 2).sum())
        max_abs = max(max_abs, float(err.abs().max()))
    return same / max(total, 1), (num / den) ** 0.5, max_abs


def check_k3(name: str, init, got, want, f32):
    """Hold ``got`` (a kernel's K3 step from the bf16 tables ``init``)
    against ``want`` (the plain version's K3 step) and ``f32`` (the plain
    f32-table step, K1b, from the same values) by the K3 rules above;
    raises AssertionError past them.  Returns (max abs element error,
    relative L2 error, f32-table distance, identical share)."""
    want = list(want)
    same, l2, max_abs = k3_update_errors(init, got, want)
    _, dist, _ = k3_update_errors(init, f32, want)
    if same < K3_IDENTICAL:
        raise AssertionError(f"{name}: {same:.4f} of touched elements "
                             f"bit-identical < {K3_IDENTICAL}")
    if l2 > K3_L2:
        raise AssertionError(f"{name}: relative L2 error {l2:.3e} > {K3_L2}")
    if dist < BF16_APART * l2:
        raise AssertionError(
            f"{name}: the f32-table step lies {dist:.3e} from the K3 step, "
            f"not {BF16_APART}x the error {l2:.3e}")
    return max_abs, l2, dist, same


def emulate_k3(seed: int, sr: bool = True, groups: int = 128, L: int = 80,
               W: int = 10, KP: int = 2048, R: int = 1, lr: float = 0.025,
               d: int = 128, graph=None):
    """What the kernel may differ by in one K3 step at chip_smoke's K3
    shapes: walks of L on the synthetic-10m graph from uniform starts,
    unigram pools, made from ``seed``.  The plain step (f32 sums) against an
    emulated kernel step: float64 sums, the one way the kernel still departs
    from the plain version (both write each group's rows in slot order and
    each pool's in draw order, with the same rounding bits).  Returns the
    :func:`check_k3` readings of the emulated step: (identical share,
    relative L2 error, f32-table (K1b) distance).  ``graph`` replaces the
    synthetic-10m graph."""
    from come_tpu_torch.graphs import get_dataset
    from come_tpu_torch.ops import walk_sgns as ws
    from come_tpu_torch.sampling import (
        build_alias_table,
        random_walks,
        sample_alias,
        unigram_weights,
    )

    graph = graph or get_dataset("synthetic-10m").graph
    V = graph.num_nodes
    g = torch.Generator().manual_seed(seed)
    init = [(torch.randn((V, d), generator=g) * 0.1).to(torch.bfloat16)
            for _ in range(2)]
    walks = random_walks(graph.to_device("cpu"),
                         torch.randint(0, V, (8 * groups,), generator=g),
                         L, g)
    wrow = torch.randint(1, W + 1, (groups * ws.NWL,), generator=g,
                         dtype=torch.int32)
    accept, alias = (torch.as_tensor(a) for a in
                     build_alias_table(unigram_weights(graph.degrees)))
    pools = sample_alias(accept, alias, g, (-(-groups // R), KP))
    kw = dict(window=W, pool_refresh=R, sr_seed=seed if sr else None)

    def step(tables, **extra):
        return ws.walk_sgns_step_reference(
            *tables, walks, wrow, pools, lr, 5.0 / KP, **{**kw, **extra})[:2]

    plain = step([t.clone() for t in init])
    kern = step([t.clone() for t in init], acc=torch.float64)
    k1b = step([t.float() for t in init], mxu_bf16=True)
    same, l2, _ = k3_update_errors(init, kern, plain)
    _, dist, _ = k3_update_errors(init, k1b, plain)
    return same, l2, dist


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="K3's float64 emulation")
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--groups", type=int, default=128)
    args = p.parse_args(argv)
    torch.set_num_threads(4)
    for sr in (True, False):
        for seed in args.seeds:
            same, l2, dist = emulate_k3(seed, sr, args.groups)
            print(f"K3 {'SR' if sr else 'truncation'} seed {seed} groups "
                  f"{args.groups}: identical {same:.5f} rel_l2 {l2:.3e} "
                  f"f32-table distance {dist:.3e} ({dist / l2:.1f}x)",
                  flush=True)


if __name__ == "__main__":
    main()
