"""P4 on the card: the fixed cost of one group of the port's group loops.

    python -m come_tpu_torch.tools.probe_star_floor

The counterpart of ``scripts/probe_star_floor.py``.  With its inputs (G 338
groups, V 10312, d 128; from ``np.random.default_rng(0)``: slots, an
[8, 128] meta tile per group, the table, and a 1024-entry pool), it runs the
seven variants of ``ops/floor_probe.py`` (one launch per group, each adding
one input stream), holds each variant's value exactly against its plain
version (and variants ``table`` and ``gather``'s copy of the table bit for
bit against the input), and prints µs per group for each: CUDA events,
after one warm-up, the median of 3 samples of 4 chained runs.  Needs a CUDA
card; about a second.
"""

from __future__ import annotations

import numpy as np
import torch

from come_tpu_torch.tools.probe_star import chained_us

NWL = 1024
G = 338
V, D = 10312, 128


def inputs(device):
    """(slots, pool, scal, meta, emb) as probe_star_floor.py:48-55 and
    :114-115 make them (the pool broadcast to one block per 8 groups)."""
    rng = np.random.default_rng(0)
    slots = rng.integers(0, V, G * NWL).astype(np.int32)
    meta = rng.integers(0, 128, (G * 8, 128)).astype(np.int32)
    emb = rng.normal(size=(V, D)).astype(np.float32)
    sneg = rng.integers(0, V, 1024).astype(np.int32)
    pool = np.broadcast_to(sneg, (-(-G // 8), 1024)).reshape(-1)
    scal = np.ones(2, np.float32)
    dev = torch.device(device)
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=dev)
                 for a in (slots, pool, scal, meta, emb))


def run(device="cuda", log=print) -> dict:
    """Check and time the seven variants on ``device`` (a CUDA card);
    returns {variant: (µs per group, value)} and the gather variant's ms
    per run and its plain version's."""
    from come_tpu_torch.ops.floor_probe import (
        LABELS,
        VARIANTS,
        floor_probe,
        floor_probe_reference,
    )

    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"probe_star_floor times a CUDA card, not {dev}")
    args = inputs(dev)
    emb = args[-1]
    out = {}
    for name in VARIANTS:
        value, table = floor_probe(name, *args)
        want, want_table = floor_probe_reference(name, *args)
        torch.cuda.synchronize()
        if float(value) != float(want):
            raise AssertionError(f"P4 {name}: {float(value)} != plain "
                                 f"{float(want)}")
        if want_table is not None and not torch.equal(table, emb):
            raise AssertionError(f"P4 {name}: the table copy differs")
        us = chained_us(lambda: floor_probe(name, *args), G)
        out[name] = (us, float(value))
        log(f"P4 {LABELS[name]:30s} {us:7.2f} us/group (value "
            f"{float(value):.6g})")
    gather_ms = out["gather"][0] * G / 1e3
    plain_ms = chained_us(lambda: floor_probe_reference("gather", *args), 1)
    return {"variants": out, "ms": gather_ms, "plain_ms": plain_ms / 1e3,
            "G": G, "V": V, "d": D}


def main(argv=None) -> int:
    run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
