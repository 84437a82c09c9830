"""P4, the per-group floor probe: the CUDA kernels, their plain versions and
the wrapper that picks between them by device.

Port of ``scripts/probe_star_floor.py`` (seven Pallas kernels, their
``pallas_call`` at ``:64, :81, :102, :123, :148, :176, :232``), which found
the fixed cost of one TPU grid step by adding one input stream at a time to
an empty kernel.  On the card a grid step becomes one stream-ordered launch
per group, the port's group unit (``csrc/star_sgns.cu``): each variant
launches one small kernel per group over G groups (kernel source
``csrc/floor_probe.cu``) and returns the value the TPU variant returns,
read at the last group:

  bare          nothing read                                    1.0
  slots         each group's 1024 slots, one at a time by one   slots[(G-1)*1024]
                thread (the TPU's SMEM block)
  slots_tile    the same slots as an [8, 128] tile read by the  the same
                whole block (the TPU's VMEM block)
  smem_streams  slots, plus the pool block every 8 groups and   + pool[((G-1)//8)*1024]
                two scalars (the star kernel's SMEM set)
  meta          slots, plus the group's [8, 128] meta tile      + meta[(G-1)*8, 0]
  table         slots, plus a [V, d] copy of emb into a second  slots[(G-1)*1024]
                table at group 0
  gather        table, plus each group's 1024 rows gathered     emb[slots[(G-1)*1024], 0]
                from it into a [1024, d] buffer
"""

from __future__ import annotations

import torch

from come_tpu_torch.ops import build

NWL = 1024  # slots per group
# variant name -> the C entry's variant number (csrc/floor_probe.cu)
VARIANTS = {"bare": 1, "slots": 2, "slots_tile": 7, "smem_streams": 3,
            "meta": 4, "table": 5, "gather": 6}
# the TPU probe's labels (scripts/probe_star_floor.py:72-260)
LABELS = {
    "bare": "bare grid",
    "slots": "+ SMEM slots [1024]/group",
    "slots_tile": "+ VMEM slots [8,128]/group",
    "smem_streams": "+ all SMEM streams",
    "meta": "+ SMEM slots + VMEM meta",
    "table": "+ table in/out + i0 DMA",
    "gather": "6: 5 + gather loop",
}
_TABLE = ("table", "gather")


def floor_probe_reference(variant: str, slots, pool, scal, meta, emb):
    """Plain version of :func:`floor_probe`: the last group's value from
    the inputs, and a copy of ``emb`` for the variants that copy it."""
    G = slots.numel() // NWL
    s0 = slots.reshape(-1)[(G - 1) * NWL].long()
    if variant == "bare":
        v = torch.ones((), dtype=torch.float32)
    elif variant in ("slots", "slots_tile", "table"):
        v = s0.float()
    elif variant == "smem_streams":
        v = (s0 + pool.reshape(-1)[((G - 1) // 8) * NWL].long()).float()
    elif variant == "meta":
        v = (s0 + meta.reshape(-1)[(G - 1) * NWL].long()).float()
    elif variant == "gather":
        v = emb[s0, 0].float()
    else:
        raise ValueError(f"unknown floor probe variant {variant!r}")
    return v.to(emb.device), (emb.clone() if variant in _TABLE else None)


def floor_probe(variant: str, slots, pool, scal, meta, emb):
    """Run one floor-probe variant over G = len(slots) / 1024 groups.

    Args:
      slots: int32 [G * 1024]; pool: int32 [ceil(G / 8) * 1024] (one
        1024-entry pool block per 8 groups); scal: f32 [2]; meta: int32
        [G * 8, 128]; emb: f32 [V, d], d a multiple of 4 on the card.

    Returns (value, table): the last group's value as a 0-dim f32 tensor
    and, for ``table`` and ``gather``, the copy of ``emb`` (else None).  CPU
    tensors run the plain version; CUDA tensors launch the kernels (one call
    counted in ``floor_probe.launches``) or raise.
    """
    if variant not in VARIANTS:
        raise ValueError(f"unknown floor probe variant {variant!r}")
    if slots.numel() % NWL:
        raise ValueError(f"slots must be whole groups of {NWL}")
    if emb.device.type == "cpu":
        return floor_probe_reference(variant, slots, pool, scal, meta, emb)
    if emb.device.type != "cuda":
        raise ValueError(f"no floor probe kernel for device {emb.device}")
    dev = emb.device
    ints = [a.to(dev, torch.int32).contiguous() for a in (slots, pool, meta)]
    slots, pool, meta = ints
    scal = scal.to(dev, torch.float32).contiguous()
    emb = emb.contiguous()
    V, d = emb.shape
    if emb.dtype != torch.float32 or d % 4:
        raise ValueError("emb must be f32 [V, d] with d % 4 == 0")
    G = slots.numel() // NWL
    if pool.numel() < -(-G // 8) * NWL or meta.numel() != G * NWL or \
            scal.numel() < 2:
        raise ValueError(f"pool needs {-(-G // 8) * NWL} ids, meta "
                         f"{G * NWL} and scal 2 for {G} groups")
    table = torch.empty_like(emb) if variant in _TABLE else None
    phi = (torch.empty((NWL, d), dtype=torch.float32, device=dev)
           if variant == "gather" else None)
    stats = torch.zeros(2, dtype=torch.float32, device=dev)
    sinks = torch.zeros(128, dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    code = build.library().come_floor_probe(
        VARIANTS[variant], ptr(slots), ptr(pool), ptr(scal), ptr(meta),
        ptr(emb), ptr(table), ptr(phi), ptr(stats), ptr(sinks), G, V, d,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    floor_probe.launches += 1
    build.check(code, "come_floor_probe")
    return stats[0], table


floor_probe.launches = 0
