"""Random-walk generation on the device.

Port of ``come_tpu/sampling/walks.py``: a batch of walks ``[B, L]`` is one
loop of L-1 flat CSR gathers over the whole batch, with all the draws made
up front.  Each step takes a 24-bit uniform ``u`` and the neighbour at
``floor(u * deg)`` (exactly uniform for deg < 2^24, the JAX walker's rule);
isolated nodes stay put, and ``restart_prob`` returns a walk to its origin.
"""

from __future__ import annotations

import torch

from come_tpu_torch.graphs.csr import DeviceCSR


def random_walks(
    csr: DeviceCSR,
    start_nodes: torch.Tensor,
    length: int,
    generator: torch.Generator,
    restart_prob: float = 0.0,
) -> torch.Tensor:
    """Uniform truncated random walks: int32 [B, length] on ``csr``'s device.

    ``generator`` must live on the same device as ``csr``."""
    dev = csr.indices.device
    v = start_nodes.to(device=dev, dtype=torch.long)
    B = v.shape[0]
    if csr.num_arcs == 0:  # every node isolated: every walk stays put
        return v.to(torch.int32)[:, None].expand(B, length).contiguous()
    bits = torch.randint(
        0, 1 << 24, (max(length - 1, 0), B), generator=generator, device=dev
    )
    u_all = bits.to(torch.float32) * (1.0 / (1 << 24))
    if restart_prob > 0.0:
        restart = (
            torch.rand((max(length - 1, 0), B), generator=generator, device=dev)
            < restart_prob
        )
    origin = v
    ptr_deg = csr.ptr_deg.long()
    indices = csr.indices.long()
    walks = torch.empty((length, B), dtype=torch.int32, device=dev)
    walks[0] = v.to(torch.int32)
    for t in range(1, length):
        pd = ptr_deg[v]
        lo, deg = pd[:, 0], pd[:, 1]
        r = torch.minimum(
            (u_all[t - 1] * deg.to(torch.float32)).long(),
            (deg - 1).clamp_min(0),
        )
        # isolated rows index past their (empty) range; clamp, then discard
        nxt = indices[(lo + r).clamp_max(indices.shape[0] - 1)]
        nxt = torch.where(deg > 0, nxt, v)  # isolated nodes stay put
        if restart_prob > 0.0:
            nxt = torch.where(restart[t - 1], origin, nxt)
        v = nxt
        walks[t] = v.to(torch.int32)
    return walks.T.contiguous()
