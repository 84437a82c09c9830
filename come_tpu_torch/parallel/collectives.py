"""The sharded update rules and the collectives they run on.

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

The row-sharded tier (model axis > 1) moves rows between their owners and
the workers that train them with :func:`all_to_all_` and gathers whole
tables with :func:`all_gather_`, over the model group.  Their transport is
chosen from the group's backend, never because something failed: under
NCCL the device tensors go straight to ``all_to_all_single`` /
``all_gather_into_tensor``; under gloo, which has no CUDA all-to-all, a
card's tensors are copied to pinned host memory, exchanged there and
copied back ("gloo-host"); CPU tensors over gloo go as they are
("gloo").  An error of NCCL raises.

``METER`` counts the all-reduces and the all-to-alls (with the
all-gathers) apart: calls, bytes and, with ``METER.timing`` on a CUDA
device, their time between CUDA events recorded on the current stream
around each call; ``METER.transport`` names the exchange's last transport.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class AllReduceMeter:
    """Calls, bytes and (with ``timing``) CUDA-event milliseconds of the
    all-reduces and, apart, of the row exchange's all-to-alls and
    all-gathers (``a2a_*``) since the last :meth:`reset`."""

    def __init__(self):
        self.timing = False
        self.transport = None
        self.reset()

    def reset(self) -> None:
        self.calls = 0
        self.bytes = 0
        self._events: list = []
        self.a2a_calls = 0
        self.a2a_bytes = 0
        self._a2a_events: list = []

    @staticmethod
    def _ms(events) -> float:
        if not events:
            return 0.0
        events[-1][1].synchronize()
        return sum(a.elapsed_time(b) for a, b in events)

    def ms(self) -> float:
        """All-reduce milliseconds between the recorded events
        (synchronises)."""
        return self._ms(self._events)

    def a2a_ms(self) -> float:
        """All-to-all and all-gather milliseconds (synchronises)."""
        return self._ms(self._a2a_events)

    def _start(self, t: torch.Tensor):
        if not (self.timing and t.device.type == "cuda"):
            return None
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        return ev


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
    ev = METER._start(t)
    dist.all_reduce(t, group=group)
    if ev:
        ev[1].record()
        METER._events.append(ev)
    return t


def transport(group=None) -> str:
    """The row exchange's transport over ``group`` for tensors on a
    card: "nccl" (device to device) or "gloo-host" (staged through pinned
    host memory); "local" with no process group.  Raises for any other
    backend."""
    if not _initialised():
        return "local"
    backend = dist.get_backend(group)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"no row exchange over backend {backend}")
    return "nccl" if backend == "nccl" else "gloo-host"


def _exchange(fn, out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """Run the collective ``fn(out, inp, group=...)`` on the group's
    transport (:func:`transport`), metered under ``a2a_*``."""
    METER.a2a_calls += 1
    METER.a2a_bytes += inp.numel() * inp.element_size()
    ev = METER._start(inp)
    way = transport(group)
    if way == "gloo-host" and inp.device.type == "cuda":
        h_in = torch.empty(inp.shape, dtype=inp.dtype, pin_memory=True)
        h_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        h_in.copy_(inp)
        fn(h_out, h_in, group=group)
        out.copy_(h_out, non_blocking=True)
    else:
        if way == "gloo-host":
            way = "gloo"
        fn(out, inp, group=group)
    METER.transport = way
    if ev:
        ev[1].record()
        METER._a2a_events.append(ev)


def all_to_all_(out: torch.Tensor, inp: torch.Tensor, group=None
                ) -> torch.Tensor:
    """The tiled all-to-all of ``jax.lax.all_to_all(split_axis=0,
    concat_axis=0, tiled=True)`` over ``group``: block i of ``inp``'s
    first dimension goes to rank i, and block i of ``out`` is what rank i
    sent this rank.  With no process group (one rank) ``out`` is a copy
    of ``inp``.  Returns ``out``."""
    if not _initialised():
        METER.a2a_calls += 1
        METER.a2a_bytes += inp.numel() * inp.element_size()
        return out.copy_(inp)
    _exchange(dist.all_to_all_single, out, inp.contiguous(), group)
    return out


def all_gather_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` stacked along the first dimension in group-rank
    order, on ``t``'s device: [n * rows, ...]."""
    n, _ = world_rank(group)
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    if not _initialised():
        return out.copy_(t)
    # all_gather_single is the name since torch 2.13
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    _exchange(fn, out, t.contiguous(), group)
    return out


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
