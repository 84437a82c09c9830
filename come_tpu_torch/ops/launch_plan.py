"""Launch plans: one macro step of the walk or the star kernel, one
micro-step of K6/K7, or a macro batch of K6/K7 micro-steps, as one unit
that the card replays.

The TPU runs a macro step as one ``pallas_call`` with a grid over the groups
(``come_tpu/ops/pallas_walk_sgns.py:564``, ``pallas_star_sgns.py:282``) and
a micro-step as one with a grid over the tiles (``pallas_sgns.py:347``);
compiled once, never traced again.  Here the C entries
(``csrc/walk_sgns.cu``, ``csrc/star_sgns.cu``, ``csrc/sgns_fused.cu``)
record a step's group or tile loop once as a CUDA graph and replay it on
the caller's stream (``csrc/step_graph.cuh``).  A plan is what the host
keeps between steps for one (entry, device, stream, mode, shape):

  * the graph slot: a private recording stream and the one instance every
    step of the plan replays.  The graph's head kernel is its only node
    whose parameters a call sets: it copies the call's input arrays into
    the plan's buffers (K6/K7's packs them) and writes ``lr``, the SR seed
    and K6/K7's result pointer into the plan's argument block ``args``,
    which the later kernels read.  :meth:`LaunchPlan.begin` says whether a
    call records: the plan's first call records and instantiates
    (``RECORD_INSTANTIATE``); a call whose tables (or ``negw``, or K4's
    graph) lie elsewhere than the recording's records again and updates
    the instance (``RECORD_UPDATE``: K3's working tables each epoch, the
    row-sharded path's compact tables each step); every other call only
    replays (``RECORD_NONE``).  So ``lr``, seeds and the inputs' addresses
    are not in the key, and neither are the tables';
  * the staged inputs (``inputs``: the walks, window draws, pools, star
    slots and meta, K4's starts and draws), the step's scratch (the result
    ``stats``, ``cneg``, ``dneg``, ``dphi``, ``dctx``, ``nt``, K4's
    generated walks and a walk step's pool and slot chains) and ``args``,
    allocated once.  The head kernel zeroes
    ``stats`` (:meth:`LaunchPlan.begin` does on CPU plans, its plain
    version); :meth:`LaunchPlan.result` returns a copy, so a step's (loss,
    n_pairs) never alias the buffer the next step zeroes.  A plan's steps
    run in the order of its stream, which is in the key, so one step's
    buffers are never written while an earlier step reads them;
  * the kernels' setup (shared-memory caps, the negative pass's grid),
    which the C entry does at the plan's first step.

K6/K7's :class:`FusedPlan` also owns the packed pairs, the tiles' masks
and the pool, which the step's first kernel fills from the call's inputs,
so a call allocates nothing but its 2-float result and runs no op on the
host.  A :class:`ScanPlan` runs a macro batch of K6/K7 micro-steps as one
launch, the port of the JAX trainer's ``lax.scan`` over them
(``come_tpu/trainer/come.py:350``): a WHILE graph whose body is one
micro-step (``csrc/sgns_fused.cu``).

Each wrapper counts, beside its ``launches``, the steps it recorded
(``recordings``), the instances it made (``instantiations``) and updated
(``updates``) and the graphs it launched (``replays``), as plain integers;
:func:`used_plans` gives how many plans (shapes) stepped since
:func:`reset_used`.  On one device every plan records once: recordings =
instantiations = plans used, no update.  CPU tensors never reach a plan
(the wrappers run their plain versions), but a plan on the CPU holds CPU
buffers and no graph slot, which is how the tests exercise this logic.

A :class:`GraphPlan` is the same cache's other kind of plan: a loop of torch
ops on the device (the GMM's EM, ``losses/gmm.py``), the counterpart of
``jax.lax.while_loop``.  Its body (one iteration) and its entry are
recorded once into ``torch.cuda.CUDAGraph``s on the plan's private stream,
and a C graph slot (``csrc/step_graph.cu``'s WHILE graph) runs the entry,
then the body under a conditional WHILE node for as long as the device
state says: the whole loop is one launch on the caller's stream.
"""

from __future__ import annotations

import torch

NWL = 1024  # slots per group
BLK = 128  # rows per CTA of the negative pass
ARGS_BYTES = 128  # a plan's argument block (csrc/sgns_common.cuh: StepArgs)

# what a call asks of a plan's recording (csrc/step_graph.cuh)
RECORD_NONE, RECORD_INSTANTIATE, RECORD_UPDATE = 0, 1, 2

_PLANS: dict[tuple, "LaunchPlan"] = {}
_USED: set[tuple] = set()
# the graph plans' recording stream, one per device for the process: cuBLAS
# keeps a workspace (32 MiB on Hopper) for every stream it ran on, for good
_STREAMS: dict = {}


class LaunchPlan:
    """One (entry, device, stream, mode, shape)'s graph slot, staged inputs,
    argument block and scratch.  ``inputs``: the int32 elements of each
    input array the head kernel stages, by name."""

    def __init__(self, key: tuple, device, KP: int, d: int, *,
                 ctx: bool = True, walk_slots: int = 0, rows: int = NWL,
                 inputs: dict | None = None, chains: int = 0):
        f32 = torch.float32
        dev = torch.device(device)
        self.key = key
        self.device = dev
        self.stats = torch.zeros(2, dtype=torch.float64, device=dev)
        self.cneg = torch.empty((KP, d), dtype=f32, device=dev)
        self.dneg = torch.empty((KP, d), dtype=f32, device=dev)
        # the positive pass's part of each slot's update, then the negative
        # pass's: the scatter adds the two once, as the plain version does
        self.dphi = torch.empty((2, rows, d), dtype=f32, device=dev)
        self.dctx = (torch.empty((rows, d), dtype=f32, device=dev) if ctx
                     else None)
        self.nt = torch.empty((rows,), dtype=f32, device=dev)
        self.walks = (torch.empty((walk_slots,), dtype=torch.int32,
                                  device=dev) if walk_slots else None)
        self.inputs = {k: torch.empty((n,), dtype=torch.int32, device=dev)
                       for k, n in (inputs or {}).items()}
        # a walk step's chains: its pools', as pool_chains_kernel writes
        # them, then its groups' slots', as slot_chains_kernel does
        self.chains = (torch.empty((chains,), dtype=torch.int32, device=dev)
                       if chains else None)
        self.args = torch.zeros(ARGS_BYTES // 8, dtype=torch.int64,
                                device=dev)
        self.slot = None  # the C graph slot, made at the first CUDA step
        self.route = None  # the band or star route its recording launched
        self.pool = None  # the pool passes it launched (walk_sgns.POOL_PASSES)
        self.recorded = None  # what the instance's recording holds
        self.pending = None  # what the step begun would record
        self.recordings = self.instantiations = self.updates = 0
        self.replays = 0

    def graph_slot(self, lib) -> int:
        """The plan's C graph slot (``come_step_graph_new``), made on the
        plan's device at its first use."""
        if self.slot is None:
            with torch.cuda.device(self.device):
                slot = lib.come_step_graph_new()
            if not slot:
                raise RuntimeError("come_step_graph_new: no recording stream")
            self.slot = slot
        return self.slot

    def begin(self, recorded: tuple = ()) -> int:
        """Prepare one step whose recording would hold ``recorded`` (the
        tables' addresses, ``negw``, K4's graph): return
        ``RECORD_INSTANTIATE`` at the plan's first step,
        ``RECORD_UPDATE`` when ``recorded`` differs from the instance's,
        else ``RECORD_NONE`` (replay only).  A CPU plan zeroes ``stats``
        here, as the head kernel does on the card."""
        if self.device.type != "cuda":
            self.stats.zero_()
        _USED.add(self.key)
        self.pending = recorded
        if not self.instantiations:
            return RECORD_INSTANTIATE
        return RECORD_UPDATE if recorded != self.recorded else RECORD_NONE

    def done(self, how: int, fn) -> None:
        """Count one replayed step, and its recording if it made one (the
        instance now holds what :meth:`begin` was given), on the plan and on
        the wrapper ``fn``."""
        if how != RECORD_NONE:
            self.recorded = self.pending
        for c in (self, fn):
            c.replays += 1
            if how != RECORD_NONE:
                c.recordings += 1
            if how == RECORD_INSTANTIATE:
                c.instantiations += 1
            elif how == RECORD_UPDATE:
                c.updates += 1

    def scratch(self) -> tuple:
        """Device pointers of the C entries' scratch arguments:
        (stats, cneg, dneg, dphi, dctx or None, nt)."""
        return (self.stats.data_ptr(), self.cneg.data_ptr(),
                self.dneg.data_ptr(), self.dphi.data_ptr(),
                None if self.dctx is None else self.dctx.data_ptr(),
                self.nt.data_ptr())

    def staged(self, *names: str) -> tuple:
        """Device pointers of the staged inputs ``names``."""
        return tuple(self.inputs[n].data_ptr() for n in names)

    def result(self):
        """(loss, n_pairs) of the last step as 0-dim float32 tensors of
        their own (a copy of ``stats``)."""
        st = self.stats.to(torch.float32)
        return st[0], st[1]


class FusedPlan(LaunchPlan):
    """K6/K7's plan (``ops/sgns.py``): besides the scratch (``dphi`` and
    ``dctx``, here the contexts' update, of ``TPr`` = ceil(TP / 128) * 128
    rows), it owns every buffer the tile loop reads but the tables and the
    caller's inputs, which the step's first kernel packs into them (as
    :meth:`pack`, their plain version, does):

      * ``ids`` int32 [3, n_tiles * TP + 128]: centres, contexts and
        mask != 0 as ``ops/sgns.py::_tiles`` packs them, zero-padded (the
        extra 128 keep the negative pass's last 128-row chunk in range);
      * ``nt`` f32 [n_tiles, TPr]: each tile's mask as the kernels read it,
        rows TP.. 0;
      * ``pool`` int32 [KP].

    The step writes its (loss, n_pairs) into ``out``, a 2-float tensor of
    the call's own that :meth:`begin` makes (the one allocation of a call:
    the result the caller keeps; the stage kernel takes its address, so the
    recording does not), so :meth:`result` converts nothing and the next
    call never overwrites it."""

    def __init__(self, key: tuple, device, KP: int, d: int, TP: int,
                 n_tiles: int):
        TPr = -(-TP // BLK) * BLK
        super().__init__(key, device, KP, d, rows=TPr)
        self.TP, self.n_tiles = TP, n_tiles
        self.ids = torch.zeros((3, n_tiles * TP + BLK), dtype=torch.int32,
                               device=self.device)
        self.nt = torch.zeros((n_tiles, TPr), dtype=torch.float32,
                              device=self.device)
        self.pool = torch.empty((KP,), dtype=torch.int32, device=self.device)
        self.out = None

    def pack(self, centers, contexts, mask, pool) -> None:
        """Pack one call's P pairs (P in ((n_tiles - 1) * TP, n_tiles *
        TP]) and its pool into the plan's buffers with torch ops: the plain
        version of what ``csrc/sgns_fused.cu::fused_stage_kernel`` does at
        the start of every step on the card."""
        P, n, TP = centers.shape[0], self.n_tiles, self.TP
        ids = self.ids
        ids[0, :P].copy_(centers)
        ids[1, :P].copy_(contexts)
        torch.ne(mask, 0, out=ids[2, :P])
        if P < n * TP:
            ids[:, P:n * TP].zero_()
        self.nt[:, :TP].copy_(ids[2, :n * TP].view(n, TP))
        self.pool.copy_(pool)

    def begin(self, recorded: tuple = ()) -> int:
        self.out = torch.empty(2, dtype=torch.float32, device=self.device)
        return super().begin(recorded)

    def result(self):
        """(loss, n_pairs) of the last step: views of its own ``out``."""
        return self.out[0], self.out[1]


class ScanPlan(FusedPlan):
    """A macro batch of K6/K7 micro-steps as one launch (``ops/sgns.py::
    fused_sgns_scan``): the :class:`FusedPlan` of one micro-step, whose
    recording is the body of a WHILE graph (``loop``, built by
    ``come_fused_scan_record``; ``csrc/step_graph.cu``) that runs it while
    the argument block's ``it`` < its micro-step count.  The count, the
    batch's addresses and ``lr`` go into the block with every launch, so one
    graph serves every macro batch of one (tied, d, TP, KP, n_tiles).  A
    table that moves builds the WHILE graph anew (counted as an update).
    ``out`` holds the batch's summed (loss, n_pairs)."""

    def __init__(self, *args):
        super().__init__(*args)
        self.loop = None  # the C WHILE graph

    def release_loop(self, lib) -> None:
        if self.loop is not None:
            code, self.loop = lib.come_while_graph_free(self.loop), None
            if code:
                raise RuntimeError(f"come_while_graph_free: CUDA error "
                                   f"{code}")


class GraphPlan:
    """One (entry, device, stream, mode, shape)'s device loop: the static
    buffers its ops read and write (``bufs``), the private stream they are
    recorded on (one per device, shared by the graph plans), the recorded
    graphs and the C WHILE graph that runs them.
    :meth:`capture_while` records the loop once (one recording, one
    instantiation); :meth:`launch` runs it."""

    def __init__(self, key: tuple, device):
        self.key = key
        self.device = torch.device(device)
        self.bufs: dict = {}
        self.slot = None  # the C WHILE graph
        self.graphs: tuple = ()
        self.stream = None
        if self.device.type == "cuda":
            self.stream = _STREAMS.get(self.device)
            if self.stream is None:
                self.stream = _STREAMS[self.device] = torch.cuda.Stream(
                    self.device)
        self.recordings = self.instantiations = self.replays = 0
        self.per_run: dict = {}  # counted wrapper -> its kernels in one body

    def capture_while(self, body, go, it, max_iter, counted=()) -> None:
        """Record the loop ``while go().any() and it < max_iter: body()``:
        ``body`` records one iteration's ops; ``go`` returns the bool flags
        [n] the next iteration reads; ``it`` and ``max_iter`` are int32
        device scalars, ``it`` advanced by ``body``.  ``counted``: kernel
        wrappers whose calls inside a capture add one to their ``captured``
        (not to ``launches``); the plan keeps how many ``body`` recorded,
        for :meth:`ran`.  Thread-local capture, so the host feeder's thread
        may go on copying."""
        import ctypes

        from come_tpu_torch.ops import build

        lib = build.library()
        handle = ctypes.c_ulonglong(0)
        with torch.cuda.device(self.device):
            slot = lib.come_while_graph_new(ctypes.byref(handle))
        if not slot:
            raise RuntimeError("come_while_graph_new: no WHILE graph (the "
                               "CUDA runtime must be 12.4 or later)")
        self.slot = slot
        with torch.cuda.stream(self.stream):
            # cuBLAS's workspace for this stream, made outside the capture
            # and with no kernel run on the stream
            torch.cuda.current_blas_handle()

        def flag():
            g = go()
            build.check(lib.come_while_flag(
                g.data_ptr(), g.numel(), it.data_ptr(), max_iter.data_ptr(),
                handle.value, torch.cuda.current_stream(self.device)
                .cuda_stream), "come_while_flag")

        def record(fn):
            g = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(g, stream=self.stream,
                                  capture_error_mode="thread_local"):
                fn()
            return g

        entry = record(flag)
        before = [fn.captured for fn in counted]
        loop = record(lambda: (body(), flag()))
        self.per_run = {fn: fn.captured - n
                        for fn, n in zip(counted, before)}
        self.graphs = (entry, loop)  # their pools hold the loop's buffers
        build.check(lib.come_while_graph_build(
            slot, entry.raw_cuda_graph(), loop.raw_cuda_graph()),
            "come_while_graph_build")
        self.recordings += 1
        self.instantiations += 1

    def launch(self) -> None:
        """Run the whole loop once on the current stream."""
        from come_tpu_torch.ops import build

        build.check(build.library().come_while_graph_launch(
            self.slot, torch.cuda.current_stream(self.device).cuda_stream),
            "come_while_graph_launch")
        self.replays += 1
        _USED.add(self.key)

    def ran(self, n: int) -> None:
        """Count the kernels of ``n`` runs of the body (the iterations the
        device ran, read after :meth:`launch`) on their wrappers'
        ``launches``: what each recorded, ``n`` times."""
        for fn, k in self.per_run.items():
            fn.launches += k * n

    def release(self, lib) -> None:
        if self.slot is not None:
            code, self.slot = lib.come_while_graph_free(self.slot), None
            if code:
                raise RuntimeError(f"come_while_graph_free: CUDA error "
                                   f"{code}")
        self.graphs = ()


def plan_key(entry: str, device, stream: int, mode: tuple,
             shape: tuple) -> tuple:
    """A plan's key: the entry, device, stream, mode and shape, and nothing
    a step changes (addresses, ``lr``, seeds).  A mode's floats stay floats
    (the EM's ``reg_covar`` and ``tol`` are constants of its graph)."""
    return (entry, str(torch.device(device)), int(stream),
            tuple(m if isinstance(m, float) else int(m) for m in mode),
            tuple(int(s) for s in shape))


def _plan(key: tuple, make):
    """The plan of ``key``, made by ``make(key)`` at its first use."""
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS[key] = make(key)
    return plan


def graph_plan_for(entry: str, device, stream: int, mode: tuple,
                   shape: tuple) -> GraphPlan:
    """The :class:`GraphPlan` of ``plan_key(...)``, made at its first use
    (not yet recorded: ``plan.slot`` is None)."""
    return _plan(plan_key(entry, device, stream, mode, shape),
                 lambda k: GraphPlan(k, device))


def plan_for(entry: str, device, stream: int, mode: tuple, shape: tuple, *,
             KP: int, d: int, ctx: bool = True, walk_slots: int = 0,
             inputs: dict | None = None, chains: int = 0) -> LaunchPlan:
    """The plan of ``plan_key(...)``, made at its first use."""
    return _plan(plan_key(entry, device, stream, mode, shape),
                 lambda k: LaunchPlan(k, device, KP, d, ctx=ctx,
                                      walk_slots=walk_slots, inputs=inputs,
                                      chains=chains))


def fused_plan_for(entry: str, device, stream: int, tied: int, d: int,
                   TP: int, KP: int, n_tiles: int) -> FusedPlan:
    """K6/K7's :class:`FusedPlan` (a :class:`ScanPlan` for the entries
    "fused_scan" and "fused_scan_tied"), keyed on (entry, device, stream,
    tied, d, TP, KP, n_tiles), made at its first use."""
    kind = ScanPlan if entry.startswith("fused_scan") else FusedPlan
    return _plan(plan_key(entry, device, stream, (tied,), (d, TP, KP,
                                                          n_tiles)),
                 lambda k: kind(k, device, KP, d, TP, n_tiles))


def plans(entry: str | None = None) -> list:
    """Every plan made so far (of ``entry``)."""
    return [p for k, p in _PLANS.items() if entry is None or k[0] == entry]


def used_plans(entry: str | None = None) -> int:
    """How many plans (of ``entry``) stepped since :func:`reset_used`."""
    return sum(1 for k in _USED if entry is None or k[0] == entry)


def reset_used() -> None:
    _USED.clear()


def release_plans(lib=None, entry: str | None = None) -> None:
    """Free every plan's (of ``entry``) graph slot, its instance and stream
    (with the kernel library ``lib``), and forget the plans (a
    :class:`GraphPlan`'s graphs, their memory pool and its buffers go with
    it)."""
    keys = [k for k in _PLANS if entry is None or k[0] == entry]
    for k in keys:
        p = _PLANS.pop(k)
        _USED.discard(k)
        if isinstance(p, GraphPlan):
            p.release(lib)
            continue
        if isinstance(p, ScanPlan):
            p.release_loop(lib)
        if p.slot is not None:
            code, p.slot = lib.come_step_graph_free(p.slot), None
            if code:
                raise RuntimeError(f"come_step_graph_free: CUDA error {code}")


COUNTERS = ("recordings", "instantiations", "updates", "replays")


def wrappers() -> dict:
    """The wrappers whose steps run through plans, by entry."""
    from come_tpu_torch.ops.sgns import (
        fused_sgns_scan,
        fused_sgns_scan_tied,
        fused_sgns_step,
        fused_sgns_step_tied,
    )
    from come_tpu_torch.ops.star_sgns import star_sgns_step
    from come_tpu_torch.ops.walk_sgns import walk_sgns_gen_step, walk_sgns_step

    return {"walk_sgns": walk_sgns_step, "walk_sgns_gen": walk_sgns_gen_step,
            "star_sgns": star_sgns_step, "fused_sgns": fused_sgns_step,
            "fused_sgns_tied": fused_sgns_step_tied,
            "fused_scan": fused_sgns_scan,
            "fused_scan_tied": fused_sgns_scan_tied}


def reset_counts() -> None:
    """Zero every wrapper's graph counters and :func:`reset_used`."""
    for fn in wrappers().values():
        for c in COUNTERS:
            setattr(fn, c, 0)
    reset_used()


def graph_counts() -> dict:
    """{entry: {counter: n, ..., "shapes": plans stepped}} since
    :func:`reset_counts`."""
    return {e: {**{c: getattr(fn, c) for c in COUNTERS},
                "shapes": used_plans(e)} for e, fn in wrappers().items()}


def check_counts(where: str, counts: dict, once: bool = False) -> None:
    """Raise unless, for each entry of ``counts`` (:func:`graph_counts`),
    every recording instantiated or updated an instance, every step was
    replayed, and no shape instantiated more than once; with ``once`` (one
    device, tables that stay put), unless every plan that stepped recorded
    exactly once: recordings = instantiations = plans, no update."""
    for e, c in counts.items():
        if not (c["recordings"] == c["instantiations"] + c["updates"]
                and c["replays"] >= c["recordings"]):
            raise AssertionError(f"{where}: {e}'s graph counters {c}")
        if c["instantiations"] > c["shapes"]:
            raise AssertionError(f"{where}: {e} instantiated "
                                 f"{c['instantiations']} times for "
                                 f"{c['shapes']} shapes")
        if once and c["replays"] and not (
                c["recordings"] == c["instantiations"] == c["shapes"]
                and c["updates"] == 0):
            raise AssertionError(f"{where}: {e} recorded more than once a "
                                 f"plan: {c}")
