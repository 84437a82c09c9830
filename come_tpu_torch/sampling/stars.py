"""Shared-source fan-out ("star") layout for the O2 edge pass.

Port of ``come_tpu/sampling/stars.py`` (identical output): the arcs'
orientation, their stable sort by source and their greedy packing into
rows run in C++ (``native/stars.cpp``, built with g++ at first use; a
failed build raises).

The reference's O2 learner streams the edge list and trains each edge in
both directions with the per-pair Cython kernel (reference
``ADSCModel/node_embeddings.py::Node2Vec.train`` [R], SURVEY.md C7/§3.3).
The TPU paired tier reproduced that shape 1:1 — two staged slots per edge,
one trained pair per slot — which makes its per-group economics 5-6x worse
than O1's walk-banded tier (staging row-ops dominate group time, and
paired groups train ~1k pairs where walk groups train ~5.7k).

This module builds the layout that breaks that ceiling: arcs are grouped
by SOURCE into *segments* (a hub node followed by its fan-out neighbors),
segments are packed back-to-back into 128-slot rows, and the fused kernel
(``ops/star_sgns.py``) trains every (hub <-> neighbor) pair of a
segment from one staging of the segment's rows.  A segment of fan-out f
occupies f+1 slots and trains 2f pairs, so pairs/slot approaches 2 —
double the paired tier — while tied-table staging (O2 reads and writes
only ``node_embedding``, SURVEY.md C7) halves the row-ops per slot.

Layout invariants (asserted by tests/test_stars.py):
  * every undirected edge appears exactly ONCE, as a neighbor slot in a
    segment hubbed by one of its endpoints (the kernel trains u->v and
    v->u from that single slot);
  * segments never span 128-slot row boundaries (a segment that would
    cross is split, repeating the hub — the kernel's mask is built from
    per-slot segment ids and only pairs slots within one row);
  * pad slots carry meta == -2 and node 0, and self-mask in the kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np

from come_tpu_torch.native.build import load_stars

ROW = 128  # slots per packed row == the kernel's walk-block width

PAD_META = -2  # seg -1 / hub 0 under the meta = seg*2 + is_hub encoding


def build_star_layout(
    u: np.ndarray,
    v: np.ndarray,
    num_nodes: int,
    row_slots: int = ROW,
    max_fanout: int = 32,
) -> tuple[np.ndarray, np.ndarray]:
    """Pack an undirected edge list into hub/fan-out star rows.

    Args:
      u, v: int arrays [E], one entry per undirected edge.
      num_nodes: V (for degree-based orientation).
      row_slots: slots per row (the kernel's block width; 128).

    Returns (slots, meta), both int32 of equal length T (a multiple of
    ``row_slots``):
      slots[t]: node id staged at slot t (0 at pads)
      meta[t]:  seg_id * 2 + is_hub; PAD_META at pads.

    Segment ids are LOCAL TO THEIR ROW (0..row_slots/2-1): the kernel
    only compares meta within one row (segments never span rows), and
    small ids keep meta f32-exact for the in-kernel lane->sublane
    transpose of the metadata vector.

    Each edge is assigned to its HIGHER-degree endpoint as hub (ties to
    the smaller id) — fewer, fatter segments means fewer hub slots and
    pairs/slot closer to 2.

    ``max_fanout`` caps a segment's neighbor count (splitting repeats the
    hub).  It bounds the largest synchronously-applied per-row update (a
    hub's positive gradients and fan-out-scaled negative weight apply
    from group-start state with no sequential sigmoid feedback), and the
    per-epoch row shuffle then scatters a big hub's split segments
    across groups like the arc-permuted paired tier does.  Measured A/B
    on the BlogCatalog config (scripts/probe_star_stability.py): capped
    and uncapped are quality-equivalent (NMI 0.954 vs 0.959, same
    embedding scale) — the cap is kept as a nearly-free precaution
    (slot efficiency 2f/(f+1) is already 1.94 at f=32) for power-law
    graphs whose hubs dwarf BlogCatalog's.
    """
    if max_fanout < 1 or row_slots < 2:
        raise ValueError(f"max_fanout must be >= 1 and row_slots >= 2, got "
                         f"{max_fanout}, {row_slots}")
    E = len(u)
    if E == 0:
        return (np.zeros((row_slots,), np.int32),
                np.full((row_slots,), PAD_META, np.int32))
    V = max(num_nodes, int(max(np.max(u), np.max(v))) + 1)
    if V > np.iinfo(np.int32).max or min(np.min(u), np.min(v)) < 0:
        raise ValueError("node ids must lie in [0, 2^31 - 1)")
    u = np.ascontiguousarray(u, np.int32)
    v = np.ascontiguousarray(v, np.int32)
    lib = load_stars()
    P32 = ctypes.POINTER(ctypes.c_int32)
    P64 = ctypes.POINTER(ctypes.c_int64)
    dst_s = np.empty((E,), np.int32)
    hubs = np.empty((V,), np.int32)
    starts = np.empty((V,), np.int64)
    ends = np.empty((V,), np.int64)
    n_seg = lib.come_star_sort(
        u.ctypes.data_as(P32), v.ctypes.data_as(P32), E, V,
        dst_s.ctypes.data_as(P32), hubs.ctypes.data_as(P32),
        starts.ctypes.data_as(P64), ends.ctypes.data_as(P64))
    # worst case: a segment is cut every min(max_fanout, row_slots-1)
    # neighbors (each cut repeats the hub), plus <= row_slots-2 pad slots
    # per forced row break.  The divisor must honor max_fanout — with the
    # old row_slots-only budget, a single hub of degree ~11k overflowed
    # the buffer at the default cap (round-5 review finding, reproduced).
    cut = max(1, min(max_fanout, row_slots - 1))
    cap = E + n_seg + E // cut + n_seg * 2 + 2 * row_slots
    slots = np.zeros((cap,), np.int32)
    meta = np.full((cap,), PAD_META, np.int32)
    c = lib.come_star_pack(
        hubs.ctypes.data_as(P32), starts.ctypes.data_as(P64),
        ends.ctypes.data_as(P64), n_seg, dst_s.ctypes.data_as(P32),
        row_slots, max_fanout, slots.ctypes.data_as(P32),
        meta.ctypes.data_as(P32), slots.shape[0])
    if c < 0:
        raise RuntimeError("come_star_pack: the layout passed its buffer")
    T = -(-c // row_slots) * row_slots
    return slots[:T].copy(), meta[:T].copy()


def star_layout_stats(slots: np.ndarray, meta: np.ndarray) -> dict:
    """Occupancy accounting for logs/tests: pairs, slots, utilization."""
    meta = np.asarray(meta)
    pads = int(np.sum(meta == PAD_META))
    hubs = int(np.sum((meta != PAD_META) & (meta & 1 == 1)))
    arcs = int(np.sum((meta != PAD_META) & (meta & 1 == 0)))
    return {
        "slots": int(meta.shape[0]),
        "arcs": arcs,
        "hubs": hubs,
        "pads": pads,
        "pairs": 2 * arcs,
        "pairs_per_slot": 2.0 * arcs / max(meta.shape[0], 1),
    }
