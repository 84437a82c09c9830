"""The data-parallel update rule: every rank applies every rank's delta.

The kernels update their tables in place, so a rank snapshots a table
before its step, runs the step on its shard of the batch, and then applies
the rule of ``come_tpu/parallel/sharded.py`` for the table it updated:

* f32 tables: ``table = before + all_reduce(table - before)`` (``:805-806``,
  ``:992``);
* bf16 working tables (K3): the deltas are taken and summed in f32 and the
  sum is rounded once, to nearest even, onto ``before`` (``:794-803``), so
  the replicas stay bit-identical;
* the paired O2 step (K5) on two copies of the tied table:
  ``before + all_reduce(new_in + new_out - 2 * before)`` (``:1152-1154``).

Every rank adds the same reduced values to the same ``before``, so the
replicas stay bit-identical.  The all-reduce runs on the process group's
own backend (NCCL on the card, gloo on the CPU or, for a rehearsal, on a
card that several ranks share); nothing here picks or changes one.  With
no process group initialised (the one-process mesh) the all-reduce is the
identity.

``METER`` counts the all-reduces, their bytes and, with ``METER.timing``
on a CUDA device, their time between CUDA events recorded on the current
stream around each call.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class AllReduceMeter:
    """Calls, bytes and (with ``timing``) CUDA-event milliseconds of the
    all-reduces since the last :meth:`reset`."""

    def __init__(self):
        self.timing = False
        self.reset()

    def reset(self) -> None:
        self.calls = 0
        self.bytes = 0
        self._events: list = []

    def ms(self) -> float:
        """Total milliseconds between the recorded events (synchronises)."""
        if not self._events:
            return 0.0
        self._events[-1][1].synchronize()
        return sum(a.elapsed_time(b) for a, b in self._events)


METER = AllReduceMeter()


def _initialised() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_rank(group=None) -> tuple[int, int]:
    """(ranks in ``group``, this process's rank): (1, 0) with no process
    group initialised."""
    if not _initialised():
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the group's ranks in place and return it."""
    METER.calls += 1
    METER.bytes += t.numel() * t.element_size()
    if not _initialised():
        return t
    timed = METER.timing and t.device.type == "cuda"
    if timed:
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
    dist.all_reduce(t, group=group)
    if timed:
        ev[1].record()
        METER._events.append(ev)
    return t


def all_reduce_max(t: torch.Tensor, group=None) -> torch.Tensor:
    """Elementwise max of ``t`` over the ranks, in place (not metered)."""
    if _initialised():
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def reduce_deltas_(tables, befores, group=None) -> None:
    """Apply the data-parallel rule to ``tables`` updated in place from
    ``befores`` (same shapes and dtypes): one all-reduce of every table's
    delta, in f32.  f32 tables become ``before + sum``; bf16 tables
    ``bf16(f32(before) + sum)``, rounded once to nearest even."""
    n = sum(t.numel() for t in tables)
    delta = torch.empty(n, dtype=torch.float32, device=tables[0].device)
    views, off = [], 0
    for t, b in zip(tables, befores):
        v = delta[off:off + t.numel()].view(t.shape)
        if t.dtype == torch.float32:
            torch.sub(t, b, out=v)
        else:
            torch.sub(t.float(), b.float(), out=v)
        views.append(v)
        off += t.numel()
    all_reduce_(delta, group)
    for t, b, v in zip(tables, befores, views):
        if t.dtype == torch.float32:
            torch.add(b, v, out=t)
        else:
            t.copy_(v.add_(b.float()).to(t.dtype))


def reduce_tied_(table: torch.Tensor, new_in: torch.Tensor,
                 new_out: torch.Tensor, group=None) -> None:
    """The paired O2 step's rule: ``table += all_reduce(new_in + new_out -
    2 * table)``, where ``new_in`` and ``new_out`` are the step's two
    copies of the tied f32 ``table`` (``new_in`` is overwritten)."""
    delta = new_in.add_(new_out).sub_(2.0 * table)
    table.add_(all_reduce_(delta, group))
