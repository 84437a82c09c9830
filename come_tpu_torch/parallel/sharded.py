"""Data-parallel ComE training: D ranks, one process each, every rank
holding the whole tables.

Port of the data-parallel (model 1) tier of
``come_tpu/parallel/sharded.py``.  Each rank runs the single-device
trainer's steps, and so its kernels (K1, K1b or K3 for O1; K2/K2b or K5
for O2; K6/K7 or the per-pair step on the micro-batched tier), on its
column block of every epoch batch, and after each step applies the
data-parallel rule of ``parallel/collectives.py``: every rank adds the sum
of all ranks' deltas, as the JAX ``shard_map`` bodies psum them over
'data' (``:792-808`` for O1, ``:991-994`` for the star O2 step,
``:1152-1154`` for the paired one, ``:213-226`` per micro-step).  The
replicas stay bit-identical.  Losses and pair counts stay on the device
and are summed over the ranks once per epoch.

Randomness: every rank builds the same parameters from the same seed (one
all-reduce of a checksum at construction proves it).  Negatives, pools,
window draws and walks then come from a per-rank device generator seeded
from (seed, rank), as the JAX package decorrelates its data shards with
``fold_in(key, axis_index('data'))`` (``:689``).  One host generator is
common to every rank: it draws the epoch's start permutation, the star-row,
edge and arc shuffles and the GMM init, so every rank cuts the same global
batch.  A K3 step's stochastic-rounding seed is the common draw mixed with
the rank.

The JAX data-parallel tier never generates walks inside the kernel, so K4
is off this path.  The model axis (row-sharded tables over all_to_all) is
ROADMAP item 8b.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.distributed as dist

from come_tpu_torch.config import ComEConfig
from come_tpu_torch.graphs.csr import CSRGraph
from come_tpu_torch.iohelpers import persist
from come_tpu_torch.losses.gmm import gmm_em_fit_sharded
from come_tpu_torch.native import HostWalkFeeder
from come_tpu_torch.ops.walk_sgns import NW, mix32, walk_sgns_step
from come_tpu_torch.parallel.collectives import (
    all_reduce_,
    all_reduce_max,
    reduce_deltas_,
    reduce_tied_,
)
from come_tpu_torch.parallel.mesh import MODEL_AXIS_TODO, MeshLayout
from come_tpu_torch.trainer.come import ComETrainer


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s device generator."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


class ShardedComETrainer(ComETrainer):
    """ComE trainer over a ('data', 'model') mesh of processes, model 1.

    ``mesh``: a ``parallel.mesh.Mesh`` (or its ``MeshLayout``) of D ranks;
    ``device``: this rank's device.  At mesh (1, 1) it is the single-device
    trainer plus a one-rank all-reduce after each step."""

    def __init__(self, graph: CSRGraph, config: ComEConfig, mesh, device,
                 seed: int | None = None):
        self.layout = mesh if isinstance(mesh, MeshLayout) else \
            MeshLayout(mesh)
        if self.layout.model_size != 1:
            raise NotImplementedError(MODEL_AXIS_TODO)
        self.workers = self.layout.data_size
        self.rank = self.layout.rank
        self.group = self.layout.group
        super().__init__(graph, config, device, seed)
        self._check_replicas()
        self.gen = torch.Generator(device=self.device).manual_seed(
            rank_seed(self.seed, self.rank))
        # the JAX dp tier walks in XLA, never inside the kernel (K4)
        self.o1_gen = False

    def _check_replicas(self) -> None:
        """Raise unless every rank built bit-identical parameters: one
        all-reduce (max) of [c, -c], c a float64 checksum of the tables."""
        c = sum(float(t.double().square().sum() + t.double().sum())
                for t in self.params.buffers())
        mm = all_reduce_max(torch.tensor([c, -c], dtype=torch.float64,
                                         device=self.device), self.group)
        if float(mm[0] + mm[1]) != 0.0:
            raise RuntimeError(
                f"ranks built different parameters (checksum max - min "
                f"{float(mm[0] + mm[1])}): every rank needs the same graph, "
                "config and seed")

    # ---------------------------------------- the data-parallel update rule

    @contextlib.contextmanager
    def _update(self, *tables):
        """Snapshot ``tables``, let the step update them in place, then
        apply every rank's delta (``collectives.reduce_deltas_``)."""
        before = [t.clone() for t in tables]
        yield
        reduce_deltas_(tables, before, self.group)

    def _shuffle(self, n: int) -> torch.Tensor:
        """A permutation from the common host generator: every rank cuts
        the same global batch."""
        return torch.randperm(n, generator=self.host_gen).to(self.device)

    def _mine(self, batch: torch.Tensor) -> torch.Tensor:
        return self.layout.local(batch, 1)

    def _sr_seed(self) -> int | None:
        s = super()._sr_seed()
        return None if s is None else mix32(s ^ mix32(self.rank))

    def _sgns_microbatched(self, *args, compact: bool = False, **kw):
        """The micro-batched tier with ``batch_pairs // D`` pairs a rank
        and the deltas summed after every micro-step, as
        ``_sgns_microbatched_sharded`` (``:156-235``) runs it: no
        compaction, so every rank runs the same number of micro-steps."""
        return super()._sgns_microbatched(*args, **kw)

    def _finish_o1(self, tot_loss, tot_pairs) -> float:
        st = all_reduce_(torch.stack([tot_loss, tot_pairs]), self.group)
        return super()._finish_o1(st[0], st[1])

    def _finish_o2(self, tot_loss, tot_pairs) -> float:
        st = all_reduce_(torch.stack([tot_loss, tot_pairs]), self.group)
        return super()._finish_o2(st[0], st[1])

    # ------------------------------------------------------------------ O1

    def host_feeder(self) -> HostWalkFeeder:
        """This rank's feeder (``_o1_epoch_host``, ``:1363-1430``): the
        walk starts split over the D ranks (``np.array_split``), batches of
        ``B // D`` with ``B = max(D, min(batch_walks, starts *
        walks_per_node) // D * D)``, seed ``seed + 7919 * rank``."""
        if self._host_feeder is None:
            cfg, D = self.cfg, self.workers
            v = len(self.walk_starts)
            B = min(cfg.batch_walks, v * cfg.walks_per_node)
            B = max(D, B // D * D)
            nodes = np.array_split(self.walk_starts, D)[self.rank]
            if nodes.size == 0:  # more ranks than starts: walk any
                nodes = self.walk_starts
            self._host_feeder = HostWalkFeeder(
                self.graph, batch=B // D, length=cfg.walk_length,
                seed=self.seed + 7919 * self.rank,
                restart_prob=cfg.restart_prob, nodes=nodes,
                pin_memory=self.device.type == "cuda",
            )
        return self._host_feeder

    # ------------------------------------------------------------------ O2

    def o2_paired_plan(self) -> tuple[int, int]:
        """(global rows per macro step B_r, steps S): ``_o2_rows_global``
        (``:847-870``), B_r rounded up to whole 8-row groups for every
        rank."""
        e2 = self._undirected_edges()[0].shape[0]
        edges_step = max(64, min(self.cfg.batch_edges // 2, e2))
        unit = self.workers * NW
        B_r = -(-edges_step // 64)
        B_r = -(-B_r // unit) * unit
        return B_r, max(1, math.ceil(e2 / (B_r * 64)))

    def o2_paired_step(self, rows: torch.Tensor, pools: torch.Tensor):
        """One paired O2 step on this rank's rows [B_r / D, 128]: K5 on two
        copies of the tied table, then ``table += all_reduce(new_in +
        new_out - 2 * table)`` (``:1145-1158``).  Advances ``words_seen``
        by the global step's slots."""
        cfg = self.cfg
        ne = self.params.node_emb
        new_in, new_out = ne.clone(), ne.clone()
        _, _, loss, npairs = walk_sgns_step(
            new_in, new_out, rows, None, pools, self.lr() * cfg.alpha,
            self.negw, window=1, pool_refresh=cfg.walk_pool_refresh,
            mxu_bf16=cfg.walk_kernel_bf16, paired=True,
        )
        reduce_tied_(ne, new_in, new_out, self.group)
        self.words_seen += float(rows.numel() * self.workers)
        return loss, npairs

    # --------------------------------------------------------- GMM, naming

    def fit_gmm(self, resp0: torch.Tensor | None = None) -> float:
        """Distributed EM (``losses.gmm.gmm_em_fit_sharded``): each rank a
        chunk of the rows, the moments summed; the responsibilities cover
        every row, so the replicas stay identical (``:1621-1629``)."""
        cfg = self.cfg
        p = self.params
        out = gmm_em_fit_sharded(
            p.node_emb, None, p.num_communities, self.host_gen, self.group,
            n_init=cfg.gmm_n_init, max_iter=cfg.gmm_max_iter,
            reg_covar=cfg.reg_covar, tol=cfg.gmm_tol, resp0=resp0,
        )
        p.centroid.copy_(out["means"])
        p.chol_cov.copy_(out["chol"])
        p.inv_cov.copy_(out["inv_cov"])
        p.pi.copy_(out["resp"])
        return float(out["log_likelihood"])

    def o1_tier(self) -> str:
        """The JAX sharded trainer's name of the O1 tier (``:1466-1487``)."""
        if self.o1_walk_kernel:
            return "walk-kernel-dp"
        return ("xla-psum" if self.cfg.negative_mode == "shared"
                else "xla-per-pair")

    def o2_tier(self) -> str:
        """The JAX sharded trainer's name of the O2 tier (``:1008-1025``)."""
        if self.o2_star:
            return "star-o2-dp"
        if self.o2_paired:
            return "walk-kernel-paired-dp"
        return ("xla-psum" if self.cfg.negative_mode == "shared"
                else "xla-per-pair")

    # ---------------------------------------------------------- persistence

    def _meta(self) -> dict:
        return {"data": self.workers, "model": 1,
                "v_real": self.graph.num_nodes, "interleave": 0}

    def save_checkpoint(self, path) -> None:
        """This rank's file ``<path>.proc<rank>.npz`` of a sharded
        checkpoint (``:1631-1657``), then a barrier, so no rank reads the
        checkpoint before every file is written."""
        persist.save_checkpoint_sharded(
            path, self.params, self.words_seen, self.seed, self.rank,
            self.workers, self._meta(), gen=self.gen, host_gen=self.host_gen)
        if dist.is_available() and dist.is_initialized():
            dist.barrier(self.group)

    def load_checkpoint(self, path) -> dict:
        """Restore a checkpoint of either package (``:1659-1763``, model 1):
        a sharded one saved on this topology from this rank's own file,
        with its generators (bit-exact resume on the CPU); any other (other
        process counts or meshes, the single-device form) merged whole by
        the elastic path, the streams left as they are.  Returns which
        generators were restored."""
        D = self.workers
        meta = (persist.load_checkpoint_meta(path, self.rank)
                or persist.load_checkpoint_meta(path, 0))
        cfg = self.cfg
        shape = (self.graph.num_nodes, cfg.dim, cfg.num_communities)
        same = (meta.get("process_count") == D and meta.get("data") == D
                and meta.get("model", 1) == 1
                and not meta.get("interleave", 0))
        if same:
            params, self.words_seen, restored = \
                persist.load_checkpoint_sharded(
                    path, self.rank, D, self.device, gen=self.gen,
                    host_gen=self.host_gen, shape=shape)
        else:
            params, self.words_seen, restored = persist.load_checkpoint(
                path, self.device, shape=shape)
        self.params = params
        return restored
