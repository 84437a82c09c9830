"""P2 on the card: how much shared memory one block may hold.

    python -m come_tpu_torch.tools.probe_smem

The counterpart of ``scripts/probe_vmem.py``, which tried TPU kernels with
ever larger VMEM scratch until one failed.  Here the probe kernel
(``ops/smem_probe.py``) asks for 16, 32, 48, 64, 96, 128, 160, 192, 224 and
227 KB of dynamic shared memory, then 228 KB, and prints OK with the sum it
read (128.0) or FAIL with the card's error name; the search stops at the
first FAIL, as the TPU script's does.  It passes only when the largest size
that ran equals ``cudaDevAttrMaxSharedMemoryPerBlockOptin`` (232 448 B on an
H100) and the size above it was refused with ``cudaErrorInvalidValue``; any
other error, or another sum, raises.  Needs a CUDA card: on the CPU there is
nothing to probe, and the search raises.  Takes about a second.
"""

from __future__ import annotations

import torch

from come_tpu_torch.ops import build
from come_tpu_torch.ops.smem_probe import smem_optin_bytes, smem_probe

SIZES_KB = (16, 32, 48, 64, 96, 128, 160, 192, 224, 227, 228)


def capacity_search(device="cuda", log=print) -> dict:
    """Run the search on ``device``; returns {"optin": bytes, "largest":
    the largest size that ran, "refused": (bytes, error name)}."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"probe_smem measures a CUDA card's shared "
                           f"memory; there is nothing to probe on {dev}")
    x = torch.ones((8, 128), dtype=torch.float32, device=dev)
    optin = smem_optin_bytes()
    largest, refused = 0, None
    for kb in SIZES_KB:
        nbytes = kb * 1024
        try:
            s = float(smem_probe(x, nbytes))
        except build.CudaError as e:
            log(f"smem {kb} KB ({nbytes} B): FAIL ({e.name})")
            refused = (nbytes, e.name)
            break
        if s != 128.0:
            raise AssertionError(f"smem {kb} KB: sum {s}, expected 128.0")
        log(f"smem {kb} KB ({nbytes} B): OK (sum={s})")
        largest = nbytes
    if largest != optin:
        raise AssertionError(f"largest size that ran {largest} B != "
                             f"MaxSharedMemoryPerBlockOptin {optin} B")
    if refused is None or refused[1] != "cudaErrorInvalidValue":
        raise AssertionError(f"the size above {largest} B was not refused "
                             f"with cudaErrorInvalidValue: {refused}")
    log(f"shared memory per block: {largest} B usable "
        f"(MaxSharedMemoryPerBlockOptin {optin} B); {refused[0]} B refused "
        f"with {refused[1]}")
    return {"optin": optin, "largest": largest, "refused": refused}


def main(argv=None) -> int:
    capacity_search()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
