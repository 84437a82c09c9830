"""Device time of G1 (``csrc/gmm_factor.cu``) beside its plain versions and
the library calls, on one card.

    python come_tpu_torch/tools/g1_times.py [--root DIR] [--label NAME]
        [--shapes N,K,D ...] [--reps 50]

For each shape ``[n_init, K, d, d]`` (default: blogcatalog's [2, 39, 128,
128], synthetic-10m's [1, 64, 128, 128] and flickr's [1, 195, 128, 128],
``config/presets.py``) it makes positive definite moments from a seed
(``moments``) and prints one JSON line with, for each of

  * ``factor``         ``gmm_factor`` (the kernel),
  * ``factor_plain``   ``gmm_factor_reference`` (cov / nk + reg I, then
                       ``torch.linalg.cholesky_ex``),
  * ``factor_lib``     ``torch.linalg.cholesky_ex`` of the formed matrix,
  * ``inverse``        ``gmm_inverse`` (the kernel),
  * ``inverse_plain``  ``gmm_inverse_reference``, which is the library call
                       ``torch.cholesky_inverse``,
  * ``inverse_lib``    ``torch.cholesky_inverse``,

three readings:

  * ``ms``, the device time per call: ``--reps`` calls back to back between
    two CUDA events, divided by ``--reps``, the median of 5 such runs after
    a warm-up.  A sleep kernel holds the card while the host enqueues the
    calls, so the wrapper's host work (checks, allocations, the ctypes
    call) is not timed; ``hidden`` says whether the sleep outlasted the
    enqueue in every run (a call that synchronises the host cannot be
    hidden: its reading then includes host time);
  * ``idle_ms``, one call between two events from an idle card, the median
    of 5 (``pass_times.cuda_ms``, the older reading: it includes the host's
    enqueue of the call);
  * ``prof_ms``, the device time of the call's kernels per call
    (``torch.profiler`` over 10 calls, ``pass_times.device_us``): for a
    library call that synchronises the host, the only reading of its
    device time alone (None when the profiler recorded no kernel, as a
    short session late in a long process sometimes does);

and ``host_ms``, the host's enqueue time per call.  ``bound_ms`` is the
least time the card could take (chip_smoke.py's rule: bytes over 3.35 TB/s
or f32 operations over 67 TFLOP/s, the larger).  Each line names the card
and its power limit (``nvidia-smi``).

``--root`` times the ``come_tpu_torch`` package of another checkout, with
kernels built from that checkout's ``csrc/``, so two trees compare on one
card in one call, in turns (run the file by its path, not with ``-m``):

    python come_tpu_torch/tools/g1_times.py --root archive_check/parent
    python come_tpu_torch/tools/g1_times.py
    python come_tpu_torch/tools/g1_times.py
    python come_tpu_torch/tools/g1_times.py --root archive_check/parent

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SHAPES = ((2, 39, 128), (1, 64, 128), (1, 195, 128))
HBM_BPS, F32_FLOPS = 3.35e12, 67e12
REG = 1e-5


def moments(dev, n, K, d, pts=260, seed=0):
    """(cov [n, K, d, d] not yet divided by nk, nk [n, K]): the scatter of
    ``pts`` points about a random mean per component, positive definite."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed + d + K)
    x = torch.randn((n, K, pts, d), generator=g, device=dev) * 0.1
    x = x + torch.randn((n, K, 1, d), generator=g, device=dev)
    return x.transpose(-1, -2) @ x, torch.full((n, K), float(pts), device=dev)


def bounds(nmat: int, d: int) -> dict:
    """Least device ms of each entry: the factor reads cov and nk and
    writes L and info, d^3 / 3 multiply-adds a matrix; the inverse reads L
    and writes inv, L^-1 and the symmetric W^T W, d^3 / 6 each."""
    def ms(flops, nbytes):
        return max(flops / F32_FLOPS, nbytes / HBM_BPS) * 1e3

    return {"factor": ms(nmat * 2.0 * d ** 3 / 3, nmat * (8.0 * d * d + 8.0)),
            "inverse": ms(nmat * 2.0 * d ** 3 / 3, nmat * 8.0 * d * d)}


class Sleeper:
    """Holds the card busy for a given time with ``torch.cuda._sleep``,
    calibrated once in cycles per millisecond."""

    def __init__(self):
        import torch

        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(1000)
        a.record()
        torch.cuda._sleep(10_000_000)
        b.record()
        torch.cuda.synchronize()
        self.cycles_per_ms = 10_000_000 / a.elapsed_time(b)

    def __call__(self, ms: float) -> None:
        import torch

        torch.cuda._sleep(int(ms * self.cycles_per_ms))


def device_ms(fn, sleep: Sleeper, reps: int = 50, runs: int = 5) -> dict:
    """Device ms per call of ``fn()``: ``reps`` calls back to back behind a
    sleep that outlasts their enqueue, between two CUDA events."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    times, hosts, hidden = [], [], True
    for _ in range(runs):
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        e0.record()
        sleep(2.0 * host_ms + 2.0)
        e1.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t1 = time.perf_counter()
        e2.record()
        torch.cuda.synchronize()
        hosts.append((t1 - t0) * 1e3)
        hidden = hidden and e0.elapsed_time(e1) > hosts[-1]
        times.append(e1.elapsed_time(e2) / reps)
        host_ms = max(host_ms, hosts[-1])
    return {"ms": statistics.median(times), "runs_ms": times,
            "host_ms": statistics.median(hosts) / reps, "hidden": hidden}


def time_shape(dev, n, K, d, reps, sleep, runs=5) -> dict:
    import torch

    from come_tpu_torch.ops.gmm_factor import (
        gmm_factor,
        gmm_factor_reference,
        gmm_inverse,
        gmm_inverse_reference,
    )
    from come_tpu_torch.tools.pass_times import cuda_ms, device_us

    cov, nk = moments(dev, n, K, d)
    A = cov / nk[..., None, None] + REG * torch.eye(d, device=dev)
    L, info = gmm_factor(cov, nk, REG)
    torch.cuda.synchronize()
    if int(info.abs().sum()):
        raise AssertionError(f"g1_times: a pivot failed at {n}x{K}x{d}")
    fns = {
        "factor": lambda: gmm_factor(cov, nk, REG),
        "factor_plain": lambda: gmm_factor_reference(cov, nk, REG),
        "factor_lib": lambda: torch.linalg.cholesky_ex(A),
        "inverse": lambda: gmm_inverse(L),
        "inverse_plain": lambda: gmm_inverse_reference(L),
        "inverse_lib": lambda: torch.cholesky_inverse(L),
    }
    out = {}
    for name, fn in fns.items():
        r = device_ms(fn, sleep, reps, runs)
        r["idle_ms"] = cuda_ms(fn)
        us = device_us(lambda i: fn(), range(10), required=False)
        r["prof_ms"] = None if us is None else us / 1e3
        out[name] = r
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                   help="the checkout whose come_tpu_torch to time")
    p.add_argument("--label", default="", help="a name for the JSON lines")
    p.add_argument("--shapes", nargs="*", default=None,
                   help="n_init,K,d triples (default: the three presets')")
    p.add_argument("--reps", type=int, default=50,
                   help="calls back to back in one device-time reading")
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("g1_times: needs a CUDA card")
    import come_tpu_torch
    from come_tpu_torch.ops import build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    build.library()
    sleep = Sleeper()
    shapes = ([tuple(int(v) for v in s.split(",")) for s in args.shapes]
              if args.shapes else SHAPES)
    for n, K, d in shapes:
        line = {"card": card, "label": args.label,
                "package": str(Path(come_tpu_torch.__file__).parent),
                "shape": [n, K, d, d], "reps": args.reps,
                "bound_ms": bounds(n * K, d)}
        line.update(time_shape(dev, n, K, d, args.reps, sleep))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
