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
"""

from __future__ import annotations

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
