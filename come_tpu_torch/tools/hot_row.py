"""Run-to-run spread of the f32 check at ``chip_smoke.py``'s hot-row shape.

    python come_tpu_torch/tools/hot_row.py [--root DIR] [--label NAME]
        [--kernels 20] [--plains 5] [--device cuda]

The shape is phase 4h's (V 2000, d 128, 16 walks of 80 with node 7 in every
other position, W 10, KP 512, R 1, lr 0.025, negw 5 / KP, tables and draws
from the same seeds).  It runs the walk step ``--kernels`` times and its
plain f32 version ``--plains`` times, and the plain version once in float64
(``acc``), and prints one JSON line with the worst ratio
|update - reference update| / (1e-6 + 1e-4 |reference update|) over every
table element (the f32 check passes at <= 1) for: the kernel against the
float64 step, the plain f32 step against it, each kernel run against each
plain f32 run (and how many of those pairs pass 1), two kernel runs and two
plain runs.  On the CPU the step's wrapper is its plain version.
``--root`` runs another checkout's ``come_tpu_torch`` (run the file by its
path, not with ``-m``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SHAPE = dict(V=2000, d=128, B=16, L=80, W=10, KP=512, R=1)
LR = 0.025


def worst_ratio(init, got, ref) -> float:
    """The largest ratio of an element's update error to the f32 bound."""
    import torch

    worst = 0.0
    for t0, a, b in zip(init, got, ref):
        t0, a, b = (x.to(torch.float64) for x in (t0, a, b))
        du = b - t0
        err = ((a - t0) - du).abs()
        worst = max(worst, float((err / (1e-6 + 1e-4 * du.abs())).max()))
    return worst


def spread(dev, kernels: int, plains: int) -> dict:
    import torch

    from come_tpu_torch.ops.walk_sgns import (
        NW,
        NWL,
        walk_sgns_step,
        walk_sgns_step_reference,
    )

    V, d, B, L, W, KP, R = (SHAPE[k] for k in "V d B L W KP R".split())
    gen = torch.Generator(device=dev).manual_seed(V + d + L)
    init = [torch.randn((V, d), generator=gen, device=dev) * 0.1
            for _ in range(2)]
    walks = torch.randint(0, V, (B, L), generator=gen, device=dev,
                          dtype=torch.int32)
    walks[:, ::2] = 7
    G = -(-B // NW)
    wrow = torch.randint(1, W + 1, (G * NWL,), generator=gen, device=dev,
                         dtype=torch.int32)
    pools = torch.randint(0, V, (-(-G // R), KP), generator=gen, device=dev,
                          dtype=torch.int32)

    def run(fn, tables, **kw):
        return fn(*[t.clone() for t in tables], walks, wrow, pools, LR,
                  5.0 / KP, window=W, pool_refresh=R, **kw)[:2]

    exact = run(walk_sgns_step_reference, [t.double() for t in init],
                acc=torch.float64)
    plain = [run(walk_sgns_step_reference, init) for _ in range(plains)]
    kern = [run(walk_sgns_step, init) for _ in range(kernels)]
    pairs = [worst_ratio(init, k, p) for k in kern for p in plain]
    return {
        "kernel_vs_f64": max(worst_ratio(init, k, exact) for k in kern),
        "plain_vs_f64": max(worst_ratio(init, p, exact) for p in plain),
        "kernel_vs_plain": max(pairs),
        "kernel_vs_plain_over_1": sum(r > 1.0 for r in pairs),
        "pairs": len(pairs),
        "kernel_vs_kernel": worst_ratio(init, kern[0], kern[-1]),
        "plain_vs_plain": worst_ratio(init, plain[0], plain[-1]),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                   help="the checkout whose come_tpu_torch to run")
    p.add_argument("--label", default="", help="a name for the JSON line")
    p.add_argument("--kernels", type=int, default=20)
    p.add_argument("--plains", type=int, default=5)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("hot_row: no CUDA card (pass --device cpu)")
    out = {"label": args.label, "device": str(dev)}
    if dev.type == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
    out.update(spread(dev, args.kernels, args.plains))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
