"""The C++ host walker and a prefetching feeder of walk batches.

Port of ``come_tpu/native/walker.py``.  :func:`host_random_walks` gives the
JAX package's walks bit for bit (the same ``walker.cpp`` arithmetic);
:class:`HostWalkFeeder` keeps its batch sequence: a ``default_rng(seed)``
permutation of the start nodes per feeder epoch, the tail batch wrapped,
and walker seed ``seed + epoch * 1_000_003 + offset``.  The feeder makes
blocks of consecutive batches, up to ``CALL_STEPS`` walk steps each, in one
walker call, so the walker's threads start once for many batches, and
queues whole blocks, so the next block is made while the consumer takes
the batches of the current one.  It yields int32 tensors; with ``pin_memory`` each batch is a tensor of its own from torch's
caching host allocator, so a caller's ``.to(device, non_blocking=True)``
records the copy's stream on the block and the allocator does not hand the
block out again before that copy has finished.
"""

from __future__ import annotations

import ctypes
import os
import queue
import threading
import time

import numpy as np
import torch

from come_tpu_torch.graphs.csr import CSRGraph
from come_tpu_torch.native.build import load_native

# walk steps of consecutive batches made in one walker call (8 MiB of int32)
CALL_STEPS = 1 << 21


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def default_threads() -> int:
    """The walker's threads: the CPUs this process may run on less one,
    which the thread that launches the kernels keeps; 1 to 16."""
    return max(1, min(len(os.sched_getaffinity(0)) - 1, 16))


def walk_batches(
    graph: CSRGraph,
    starts: np.ndarray,
    seeds,
    length: int,
    outs: list[np.ndarray],
    restart_prob: float = 0.0,
    num_threads: int | None = None,
) -> None:
    """Walk batch b of ``starts`` [nb, B] with ``seeds[b]`` into ``outs[b]``
    (int32, C-contiguous [B, length]): the walks ``host_random_walks``
    gives for those starts and that seed."""
    lib = load_native()
    starts = np.ascontiguousarray(starts, np.int32)
    if starts.ndim != 2 or length < 1 or len(seeds) != starts.shape[0] \
            or len(outs) != starts.shape[0]:
        raise ValueError(f"starts must be [nb, B] with nb seeds and outs, "
                         f"length >= 1; got {starts.shape}, {len(seeds)} "
                         f"seeds, {len(outs)} outs, length {length}")
    v = graph.num_nodes
    if starts.size and (starts.min() < 0 or starts.max() >= v):
        raise ValueError(f"start nodes outside [0, {v})")
    nb, B = starts.shape
    for out in outs:
        if (out.shape != (B, length) or out.dtype != np.int32
                or not out.flags.c_contiguous):
            raise ValueError(f"each out must be C-contiguous int32 "
                             f"{(B, length)}, got {out.dtype} {out.shape}")
    indptr = np.ascontiguousarray(graph.indptr, np.int32)
    indices = np.ascontiguousarray(graph.indices, np.int32)
    # seeds wrap to 64 bits, as ctypes.c_uint64 wraps the JAX walker's
    seed_arr = np.array([int(s) & 0xFFFFFFFFFFFFFFFF for s in seeds],
                        np.uint64)
    out_ptrs = (ctypes.POINTER(ctypes.c_int32) * nb)(*[_ptr(o) for o in outs])
    lib.come_random_walks_batched(
        _ptr(indptr), _ptr(indices), _ptr(starts), nb, B, length,
        seed_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        restart_prob, out_ptrs, num_threads or default_threads(),
    )


def host_random_walks(
    graph: CSRGraph,
    starts: np.ndarray,
    length: int,
    seed: int = 0,
    restart_prob: float = 0.0,
    num_threads: int | None = None,
) -> np.ndarray:
    """Multithreaded host-side walks [len(starts), length] (int32)."""
    starts = np.ascontiguousarray(starts, np.int32)
    if starts.ndim != 1:
        raise ValueError(f"starts must be 1-D, got {starts.shape}")
    out = np.empty((starts.size, length), np.int32)
    walk_batches(graph, starts[None], [seed], length, [out], restart_prob,
                 num_threads)
    return out


class HostWalkFeeder:
    """Walk batches made on a background thread, up to ``prefetch`` blocks
    ahead of the consumer.

    Usage:
        with HostWalkFeeder(graph, batch=256, length=80, seed=0) as feeder:
            for _ in range(n):
                walks = next(feeder).to(device, non_blocking=True)

    ``nodes``: the start-node pool (every node by default).  ``wait_s`` is
    the time the consumer has spent blocked on the queue, ``produce_s`` the
    producer's time inside the walker, ``batches`` the batches handed out.
    A failure on the producer thread is raised by the next ``next()``.
    """

    def __init__(
        self,
        graph: CSRGraph,
        batch: int,
        length: int,
        seed: int = 0,
        restart_prob: float = 0.0,
        prefetch: int = 2,
        num_threads: int | None = None,
        nodes: np.ndarray | None = None,
        pin_memory: bool = False,
    ):
        self.graph = graph
        self.batch = batch
        self.length = length
        self.restart_prob = restart_prob
        self.num_threads = num_threads
        self.pin_memory = pin_memory
        self._nodes = (
            np.arange(graph.num_nodes, dtype=np.int32)
            if nodes is None
            else np.asarray(nodes, np.int32)
        )
        if self._nodes.size == 0:
            # an empty pool would busy-spin the producer and block next()
            raise ValueError("HostWalkFeeder: empty start-node pool")
        if batch < 1 or prefetch < 1:
            raise ValueError(f"batch and prefetch must be >= 1, got {batch} "
                             f"and {prefetch}")
        load_native()  # a failed build raises here, in the caller's thread
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._block: list[torch.Tensor] = []  # the consumer's current block
        self._stop = threading.Event()
        self.wait_s = 0.0
        self.produce_s = 0.0
        self.batches = 0
        self._thread = threading.Thread(target=self._produce, daemon=True,
                                        name="HostWalkFeeder")
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _starts(self, perm: np.ndarray, ofs: int) -> np.ndarray:
        starts = perm[ofs : ofs + self.batch]
        if len(starts) < self.batch:  # wrap the tail
            starts = np.resize(np.concatenate([starts, perm]), self.batch)
        return starts

    def _produce(self):
        try:
            epoch = 0
            offsets = range(0, len(self._nodes), self.batch)
            per_call = max(1, CALL_STEPS // (self.batch * self.length))
            while not self._stop.is_set():
                perm = self._rng.permutation(self._nodes)
                for c in range(0, len(offsets), per_call):
                    ofs = offsets[c : c + per_call]
                    bufs = [torch.empty((self.batch, self.length),
                                        dtype=torch.int32,
                                        pin_memory=self.pin_memory)
                            for _ in ofs]
                    t0 = time.perf_counter()
                    walk_batches(
                        self.graph, np.stack([self._starts(perm, o)
                                              for o in ofs]),
                        [self._seed + epoch * 1_000_003 + o for o in ofs],
                        self.length, [b.numpy() for b in bufs],
                        restart_prob=self.restart_prob,
                        num_threads=self.num_threads,
                    )
                    self.produce_s += time.perf_counter() - t0
                    if not self._put(bufs[::-1]):  # popped from the end
                        return
                epoch += 1
        except BaseException as e:  # handed to the consumer, raised there
            self._put(e)

    def __iter__(self):
        return self

    def __next__(self) -> torch.Tensor:
        if self._stop.is_set():
            raise StopIteration
        if not self._block:
            t0 = time.perf_counter()
            while True:
                try:
                    item = self._q.get(timeout=0.05)
                    break
                except queue.Empty:
                    if not self._thread.is_alive() and self._q.empty():
                        raise RuntimeError("HostWalkFeeder: producer thread "
                                           "ended") from None
            self.wait_s += time.perf_counter() - t0
            if isinstance(item, BaseException):
                self._stop.set()
                raise RuntimeError("HostWalkFeeder: the producer "
                                   "failed") from item
            self._block = item
        self.batches += 1
        return self._block.pop()

    def close(self):
        """Stop the producer, wait for it (it finishes at most the block in
        hand) and drop the prefetched batches."""
        self._stop.set()
        self._thread.join(timeout=30)
        self._block = []
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
