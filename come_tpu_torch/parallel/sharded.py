"""Sharded ComE training over a ('data', 'model') mesh of processes.

Port of ``come_tpu/parallel/sharded.py``.  One process per worker; rank r
is (i_d, i_m) = divmod(r, M) (``parallel/mesh.py``).

**Model 1 (data-parallel).**  Every rank holds the whole tables and runs
the single-device trainer's steps, and so its kernels (K1, K1b or K3 for
O1; K2/K2b or K5 for O2; K6/K7 or the per-pair step on the micro-batched
tier), on its column block of every epoch batch, and after each step
applies the data-parallel rule of ``parallel/collectives.py``: every rank
adds the sum of all ranks' deltas, as the JAX ``shard_map`` bodies psum
them over 'data' (``:792-808`` for O1, ``:991-994`` for the star O2 step,
``:1152-1154`` for the paired one, ``:213-226`` per micro-step).

**Model M > 1 (row-sharded).**  V is padded to V_pad, a multiple of M;
``node_emb``, ``ctx_emb`` and ``pi`` are row-sharded over 'model', rank
(i_d, i_m) holding rows ``[i_m V_pad/M, (i_m+1) V_pad/M)``; pad rows get
no walks, no pool mass and ``pi = 0``.  With ``row_exchange`` "auto" or
"a2a" the node ids are interleaved first (``exchange.
interleave_permutation``, ``graph.permute``), so contiguous shards own
ids striped over the original order, and rows move between owners and
workers only through the bucketed all-to-all (``parallel/exchange.py``):

* O1 on the walk kernel (``walk-kernel-rowsharded``,
  ``_o1_rowsharded_scan``, ``:493-579``): each data row's walk batch is
  sliced again over 'model', each of the D*M workers draws its own pools
  and window draws, the epoch's exchange plans are made up front
  (``walk_exchange.plan_walk_macro_steps``), and every step runs K1 (K1b
  with ``walk_kernel_bf16``) on the worker's compact [U, d] tables, the
  rows of step k+1 gathered before step k lands with
  ``overlap_exchange=True`` ("auto" is off here, :meth:`_overlap_on`);
* O2 through K5 on one tied compact table (``walk-kernel-paired-
  rowsharded``, ``_o2_rowsharded_scan``, ``:1027-1108``); the star tier
  is model 1 only (``_use_star_o2``, ``:928-952``);
* the micro-batched tiers as torch ops on ``losses/sgns.py`` and
  ``losses/sgns_block.py``, as the JAX package runs them in XLA:
  per-pair negatives (and shared ones under ``row_exchange="psum"``)
  through :func:`psum_gather` / :func:`owned_scatter_add`, every model
  shard of a data row computing the same micro-batch (``:156-286``);
  shared negatives under the all-to-all with the micro-batch sliced over
  'model' too (``xla-a2a``, ``_shared_micro_scan_a2a``, ``:288-382``);
* the GMM fit by distributed EM over both axes (``losses/gmm.py::
  gmm_em_fit_sharded(model=M)``; ``:1297-1327``) and O3 on the shards
  with no communication, its loss summed over 'model'.

The compact tables and the shards are f32: the JAX row-sharded tier
keeps f32 tables, so ``o1_table_dtype`` is float32 at M > 1 and K3 is off
this tier.  The JAX compact-table budgets of 48 MiB (``:441-447``,
``:915-920``) are VMEM gates and are not ported as tier gates (ROADMAP
decision 1), nor is the banded XLA tier.

Randomness: every rank builds the same parameters from the same seed (one
all-reduce of a checksum at construction proves it).  A device generator
per worker, seeded from (seed, rank), draws the pools, window draws and
micro-step pools of the kernel and all-to-all tiers, as the JAX package
folds in both axis indices (``:523-530``); at M > 1 a second one per data
row, seeded from (seed, world + i_d), draws the walks, window pairs and
per-pair negatives, which every model shard of that row must share (at
model 1 the two are one).  One host generator is common to every rank: it
draws the epoch's start permutation, the star-row, edge and arc shuffles
and the GMM init, so every rank cuts the same global batch.  A K3 step's
stochastic-rounding seed is the common draw mixed with the rank.  The JAX
mesh tiers never generate walks inside the kernel, so K4 is off this path.
"""

from __future__ import annotations

import contextlib
import logging
import math
import time

import numpy as np
import torch
import torch.distributed as dist

from come_tpu_torch.config import ComEConfig
from come_tpu_torch.graphs.csr import CSRGraph
from come_tpu_torch.iohelpers import persist
from come_tpu_torch.losses.gmm import gmm_em_fit_sharded
from come_tpu_torch.losses.sgns import sgns_grads_from_rows
from come_tpu_torch.losses.sgns_block import sgns_block_grads_from_rows
from come_tpu_torch.models.state import FIELDS, from_numpy
from come_tpu_torch.native import HostWalkFeeder
from come_tpu_torch.ops.walk_sgns import NW, NWL, mix32, walk_sgns_step
from come_tpu_torch.parallel.collectives import (
    all_gather_,
    all_reduce_,
    all_reduce_max,
    reduce_deltas_,
    reduce_tied_,
    world_rank,
)
from come_tpu_torch.parallel.exchange import (
    interleave_permutation,
    make_exchange_plan,
)
from come_tpu_torch.parallel.mesh import MeshLayout
from come_tpu_torch.parallel.walk_exchange import (
    apply_deltas_,
    fused_walk_step_prepped,
    plan_walk_macro_steps,
    prefetch_loop,
)
from come_tpu_torch.sampling.alias import sample_alias
from come_tpu_torch.trainer.come import ComETrainer, _in_envelope

log = logging.getLogger(__name__)

# ids planned per id all-to-all: an epoch's plans are made up front, in
# chunks of at most this many ids (all of a BlogCatalog epoch at M 2)
PLAN_IDS = 1 << 23


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s device generator."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


# -------------------------------------------- the psum exchange (model > 1)


def psum_gather(table_shard, idx, index: int, group=None):
    """Rows ``idx`` (global ids, any shape) of a row-sharded table: a
    masked local gather and an all-reduce over the model group
    (``:51-61``).  ``index``: this rank's model index."""
    rows_per = table_shard.shape[0]
    local = idx.long() - index * rows_per
    ok = (local >= 0) & (local < rows_per)
    rows = torch.where(ok[..., None], table_shard[local.clamp(
        0, rows_per - 1)], 0.0)
    return all_reduce_(rows, group)


def owned_scatter_add(delta_shard, idx, upd, index: int):
    """Add the update rows ``upd`` [..., d] of the rows this shard owns
    into ``delta_shard`` (in place; returned); other shards' rows are
    dropped, their owners add them (``:64-76``)."""
    rows_per = delta_shard.shape[0]
    local = idx.long().reshape(-1) - index * rows_per
    ok = (local >= 0) & (local < rows_per)
    upd = torch.where(ok[:, None], upd.reshape(local.shape[0], -1), 0.0)
    return delta_shard.index_add_(0, torch.where(ok, local, 0), upd)


class ShardedComETrainer(ComETrainer):
    """ComE trainer over a ('data', 'model') mesh of processes.

    ``mesh``: a ``parallel.mesh.Mesh`` (or its ``MeshLayout``) of D x M
    ranks; ``device``: this rank's device.  At mesh (1, 1) it is the
    single-device trainer plus a one-rank all-reduce after each step."""

    def __init__(self, graph: CSRGraph, config: ComEConfig, mesh, device,
                 seed: int | None = None):
        lay = mesh if isinstance(mesh, MeshLayout) else MeshLayout(mesh)
        self.layout = lay
        D, M = lay.data_size, lay.model_size
        self.workers = D
        self.mesh_workers = D * M
        self.rank = lay.rank
        self.group = lay.group
        self.data_group = lay.data_group
        self.model_group = lay.model_group
        self.v_real = graph.num_nodes
        self.v_pad = math.ceil(graph.num_nodes / M) * M
        self._orig_graph = graph
        self._perm = None  # old node id -> trained row (the a2a interleave)
        # "auto" takes the all-to-all whenever there is a model axis
        # (:87-101); "psum" stays the explicit alternative
        self.row_exchange = ("a2a" if config.row_exchange in ("auto", "a2a")
                             and M > 1 else "psum")
        if self.row_exchange == "a2a":
            self._perm = interleave_permutation(graph.num_nodes, M)
            graph = graph.permute(self._perm)
        super().__init__(graph, config, device, seed)
        self._check_replicas()
        self.gen = torch.Generator(device=self.device).manual_seed(
            rank_seed(self.seed, self.rank))
        self.data_gen = self.gen
        # the JAX mesh tiers walk in XLA, never inside the kernel (K4)
        self.o1_gen = False
        self._srv: list[torch.Tensor] = []
        self.last_o1_served = 1.0
        self.last_o2_served = 1.0
        if M > 1:
            world = D * M
            self.data_gen = torch.Generator(device=self.device).manual_seed(
                rank_seed(self.seed, world + lay.data_index))
            self._shard_tables()
            shared = config.negative_mode == "shared"
            a2a = self.row_exchange == "a2a"
            self.o1_walk_kernel = self.o1_walk_kernel and a2a
            self.o1_table_dtype = torch.float32
            self.o2_star = False
            self.o2_paired = (
                a2a and shared and config.o2_mode in ("auto", "paired")
                and _in_envelope(NWL, graph.num_nodes, self.mesh_workers))

    def tier_kernels(self) -> tuple[str | None, str | None]:
        """As the one-device trainer's; at model > 1 the micro-batched
        tiers run torch ops (:meth:`_micro_rowsharded`), not K6/K7."""
        ks = super().tier_kernels()
        if self.M > 1:
            ks = tuple(None if k in ("K6", "K7") else k for k in ks)
        return ks

    # ---------------------------------------------------------------- setup

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

    def _shard_tables(self) -> None:
        """Pad the row tables to V_pad with zero rows and keep this rank's
        row block (``:118-130``)."""
        p = self.params
        a, b = self.layout.row_block(self.v_pad)
        pad = self.v_pad - self.v_real
        for k in persist.ROW_LEAVES:
            t = torch.nn.functional.pad(getattr(p, k), (0, 0, 0, pad))
            setattr(p, k, t[a:b].clone())

    @property
    def M(self) -> int:
        return self.layout.model_size

    @property
    def rows_per(self) -> int:
        return self.v_pad // self.M

    def _pad_mask(self) -> torch.Tensor:
        """1 for this shard's real rows, 0 for its pad rows."""
        a, b = self.layout.row_block(self.v_pad)
        return (torch.arange(a, b, device=self.device) < self.v_real).to(
            torch.float32)

    # ---------------------------------------- the data-parallel update rule

    @contextlib.contextmanager
    def _update(self, *tables):
        """Snapshot ``tables``, let the step update them in place, then
        apply every rank's delta (``collectives.reduce_deltas_``)."""
        before = [t.clone() for t in tables]
        yield
        reduce_deltas_(tables, before, self.data_group)

    def _shuffle(self, n: int) -> torch.Tensor:
        """A permutation from the common host generator: every rank cuts
        the same global batch."""
        return torch.randperm(n, generator=self.host_gen).to(self.device)

    def _mine(self, batch: torch.Tensor) -> torch.Tensor:
        return self.layout.local(batch, 1)

    def _model_slice(self, batch: torch.Tensor) -> torch.Tensor:
        """This worker's slice over 'model' of a data row's [S, B, ...]
        batch: ``B // M`` columns from ``model_index * (B // M)``
        (``:518-524``; columns past M * (B // M) go untrained)."""
        b = batch.shape[1] // self.M
        return batch.narrow(1, self.layout.model_index * b, b)

    def _sr_seed(self) -> int | None:
        s = super()._sr_seed()
        return None if s is None else mix32(s ^ mix32(self.rank))

    def _overlap_on(self) -> bool:
        """``overlap_exchange`` resolved (``:384-400``): True or False as
        given; "auto" is off, a documented deviation from the JAX package,
        which resolves it on (on a TPU, where the prefetched gather rides
        asynchronous collectives under the kernel, and for this tier on
        the CPU).  The prefetch itself equals the reference's: at the
        blogcatalog preset on a (2, 2) mesh the JAX trainer (the Pallas
        kernel in interpret mode on the CPU, which trains every window
        full) passes loss 1e6 at step 19 with the prefetch, and this
        trainer on the same tables, walks, pools and full windows follows
        it within 5.4e-6 and passes 1e6 at the same step
        (``tests/test_torch_prefetch.py``).  Full windows diverge without
        the prefetch too: at the full preset the JAX trainer passes 1e6
        at step 40 without it, and stays bounded only at the test's cut
        to 1 walk a node, whose learning rate falls faster; the prefetch
        brings the divergence forward.  On the card, with the kernels'
        reduced windows, the prefetch took this tier to 2.7e22 while the
        run without it trained.  Here the collectives also wait on the
        stream, so the prefetch would hide no exchange.  True gives the
        JAX semantics."""
        ov = self.cfg.overlap_exchange
        if ov is True or ov is False:
            return ov
        if ov != "auto":
            raise ValueError(f"overlap_exchange must be True, False or "
                             f"'auto'; got {ov!r}")
        return False

    # ------------------------------------------------ micro-batched tiers

    def _sgns_microbatched(self, emb_in, emb_out, c, x, negs, m, lr,
                           tie_tables: bool, compact: bool = False,
                           pools: torch.Tensor | None = None):
        """The micro-batched tier with ``batch_pairs // D`` pairs a data
        row and the deltas summed after every micro-step, as
        ``_sgns_microbatched_sharded`` (``:156-235``) runs it: no
        compaction, so every rank runs the same number of micro-steps.  At
        model 1 K6/K7 or the per-pair step on the replica; at M > 1 the
        torch-op steps of :meth:`_micro_rowsharded`."""
        if self.M == 1:
            return super()._sgns_microbatched(
                emb_in, emb_out, c, x, negs, m, lr, tie_tables, pools=pools)
        return self._micro_rowsharded(emb_in, emb_out, c, x, negs, m, lr,
                                      tie_tables, pools)

    def _micro_rowsharded(self, emb_in, emb_out, c, x, negs, m, lr,
                          tie_tables, pools):
        cfg = self.cfg
        P = c.numel()
        c, x, m = c.reshape(P), x.reshape(P), m.reshape(P).float()
        mb = max(1, min(cfg.batch_pairs // self.workers, P))
        n_micro = math.ceil(P / mb)
        pad = n_micro * mb - P
        F = torch.nn.functional
        c2 = F.pad(c, (0, pad)).view(n_micro, mb)
        x2 = F.pad(x, (0, pad)).view(n_micro, mb)
        m2 = F.pad(m, (0, pad)).view(n_micro, mb)
        if cfg.negative_mode == "shared":
            if self.row_exchange == "a2a":
                extra = -mb % self.M  # model-sliced micro-batches
                c2, x2, m2 = (F.pad(t, (0, extra)) for t in (c2, x2, m2))
                return self._shared_micro_a2a(emb_in, emb_out, c2, x2, m2,
                                              lr, tie_tables, pools)
            return self._micro_psum(emb_in, emb_out, c2, x2, None, m2, lr,
                                    tie_tables, pools)
        n2 = F.pad(negs.reshape(P, cfg.negative), (0, 0, 0, pad)).view(
            n_micro, mb, cfg.negative)
        return self._micro_psum(emb_in, emb_out, c2, x2, n2, m2, lr,
                                tie_tables, None)

    def _apply_owned(self, emb_in, emb_out, lr, tie_tables, ids_in, d_in,
                     ids_out, d_out):
        """Scatter the owned rows' updates into fresh deltas and add their
        sums over 'data' (one all-reduce)."""
        mi = self.layout.model_index
        if tie_tables:
            delta = owned_scatter_add(torch.zeros_like(emb_in),
                                      torch.cat([ids_in, ids_out]),
                                      torch.cat([d_in, d_out]) * (-lr), mi)
            apply_deltas_([emb_in], [delta], self.data_group)
            return
        din = owned_scatter_add(torch.zeros_like(emb_in), ids_in,
                                d_in * (-lr), mi)
        dout = owned_scatter_add(torch.zeros_like(emb_out), ids_out,
                                 d_out * (-lr), mi)
        apply_deltas_([emb_in, emb_out], [din, dout], self.data_group)

    def _micro_psum(self, emb_in, emb_out, c2, x2, n2, m2, lr, tie_tables,
                    pools):
        """Micro-steps through :func:`psum_gather` (``:197-234``, per-pair
        negatives ``n2``; ``_shared_micro_scan``, ``:236-286``, one pool
        per micro-step from the data row's generator): every model shard
        computes the data row's whole micro-batch, so the loss counts on
        model index 0 alone."""
        cfg = self.cfg
        mi, mg = self.layout.model_index, self.model_group
        n_micro, mb = c2.shape
        shared = n2 is None
        if shared and pools is None:
            pools = sample_alias(self.accept, self.alias, self.data_gen,
                                 (n_micro, cfg.shared_negatives))
        tot = torch.zeros(2, device=self.device)
        for i in range(n_micro):
            mc, mx, mm = c2[i], x2[i], m2[i]
            neg = pools[i] if shared else n2[i]
            phi = psum_gather(emb_in, mc, mi, mg)
            out_ids = torch.cat([mx, neg.reshape(-1)])
            rows = psum_gather(emb_out, out_ids, mi, mg)
            cpos, cneg = rows[:mb], rows[mb:]
            if shared:
                loss, npairs, (d_phi, d_cpos, d_cneg) = \
                    sgns_block_grads_from_rows(phi, cpos, cneg, mm, self.negw)
            else:
                cneg = cneg.view(mb, cfg.negative, -1)
                loss, npairs, (d_phi, d_cpos, d_cneg) = sgns_grads_from_rows(
                    phi, cpos, cneg, mm, cfg.max_exp)
                d_cneg = d_cneg.reshape(mb * cfg.negative, -1)
            self._apply_owned(emb_in, emb_out, lr, tie_tables, mc, d_phi,
                              out_ids, torch.cat([d_cpos, d_cneg]))
            tot += torch.stack([loss, npairs])
        if mi != 0:
            tot.zero_()
        return tot[0], tot[1]

    def _shared_micro_a2a(self, emb_in, emb_out, c2, x2, m2, lr, tie_tables,
                          pools):
        """Shared-negative micro-steps over the all-to-all
        (``_shared_micro_scan_a2a``, ``:288-382``): each worker trains its
        ``mb / M`` pairs of the micro-batch against its own pool; pairs
        whose rows overflowed a bucket are skipped that micro-step and
        counted in the served fraction."""
        cfg = self.cfg
        M, mi, mg = self.M, self.layout.model_index, self.model_group
        KP = cfg.shared_negatives
        n_micro, mb = c2.shape
        mbm = mb // M
        slack = cfg.a2a_capacity_slack

        def cap(n):
            return max(1, int(math.ceil(n / M * slack)))

        if pools is None:
            pools = sample_alias(self.accept, self.alias, self.gen,
                                 (n_micro, KP))
        tot = torch.zeros(2, device=self.device)
        srv = torch.zeros(n_micro, device=self.device)
        rp = self.rows_per
        for i in range(n_micro):
            sl = slice(mi * mbm, (mi + 1) * mbm)
            mc, mx, mm = c2[i, sl], x2[i, sl], m2[i, sl]
            pool = pools[i]
            if tie_tables:
                plan = make_exchange_plan(
                    torch.cat([mc, mx, pool]), rp, cap(2 * mbm + KP), mi, M,
                    mg)
                rows = plan.gather(emb_in)
                phi, cpos, cneg = rows[:mbm], rows[mbm:2 * mbm], \
                    rows[2 * mbm:]
                s = plan.served
                ok = (s[:mbm] & s[mbm:2 * mbm]).float()
            else:
                plan_in = make_exchange_plan(mc, rp, cap(mbm), mi, M, mg)
                plan_out = make_exchange_plan(torch.cat([mx, pool]), rp,
                                              cap(mbm + KP), mi, M, mg)
                phi = plan_in.gather(emb_in)
                rows = plan_out.gather(emb_out)
                cpos, cneg = rows[:mbm], rows[mbm:]
                ok = (plan_in.served & plan_out.served[:mbm]).float()
            loss, npairs, (d_phi, d_cpos, d_cneg) = \
                sgns_block_grads_from_rows(phi, cpos, cneg, mm * ok,
                                           self.negw)
            if tie_tables:
                upd = torch.cat([d_phi, d_cpos, d_cneg]) * (-lr)
                delta = plan.scatter_add(torch.zeros_like(emb_in), upd)
                apply_deltas_([emb_in], [delta], self.data_group)
            else:
                din = plan_in.scatter_add(torch.zeros_like(emb_in),
                                          d_phi * (-lr))
                dout = plan_out.scatter_add(
                    torch.zeros_like(emb_out),
                    torch.cat([d_cpos, d_cneg]) * (-lr))
                apply_deltas_([emb_in, emb_out], [din, dout],
                              self.data_group)
            tot += torch.stack([loss, npairs])
            srv[i] = ok.mean()
        self._srv.append(srv)
        return tot[0], tot[1]

    # --------------------------------------------------------- epoch stats

    def _finish(self, tot_loss, tot_pairs):
        """(loss per pair, pairs, served) of an epoch: loss and pairs
        summed over the mesh, the served fraction averaged over its steps
        and workers (1 for the tiers without buckets)."""
        srv = (torch.cat(self._srv).mean() if self._srv
               else torch.ones((), device=self.device))
        self._srv = []
        st = all_reduce_(torch.stack([tot_loss, tot_pairs, srv]), self.group)
        world, _ = world_rank(self.group)
        loss, pairs, srv = st.tolist()
        return loss / max(pairs, 1.0), pairs, srv / world

    @staticmethod
    def _warn_unserved(phase: str, served: float) -> None:
        if served < 0.999:
            log.warning("%s a2a bucket overflow: served fraction %.4f < 1 "
                        "(raise a2a_capacity_slack)", phase, served)

    def _finish_o1(self, tot_loss, tot_pairs) -> float:
        loss, self.last_o1_pairs, self.last_o1_served = self._finish(
            tot_loss, tot_pairs)
        self._warn_unserved("o1", self.last_o1_served)
        return loss

    def _finish_o2(self, tot_loss, tot_pairs) -> float:
        loss, self.last_o2_pairs, self.last_o2_served = self._finish(
            tot_loss, tot_pairs)
        self._warn_unserved("o2", self.last_o2_served)
        return loss

    # ------------------------------------------------------------------ O1

    def _rowsharded_walk_shapes(self, b_local: int | None = None):
        """(walks per worker, groups, pools) of the row-sharded walk tier
        (``:402-415``)."""
        cfg = self.cfg
        if b_local is None:
            n_starts = len(self.walk_starts) * cfg.walks_per_node
            b_global = max(1, min(cfg.batch_walks, n_starts))
            b_local = max(1, b_global // self.workers)
        b_w = max(1, b_local // self.M)
        n_groups = -(-b_w // NW)
        return b_w, n_groups, -(-n_groups // cfg.walk_pool_refresh)

    def _rowsharded_epoch(self, rows_all, n_pools: int, kernel_step,
                          tables, n_wrow: int = 0) -> None:
        """Plan and run the macro steps of this worker's ``rows_all``
        [S, B_w, L] (walks, or packed edge rows): each step's ``n_pools``
        pools (and ``n_wrow`` window draws) from the worker's generator,
        the plans made ahead of the steps that need them in chunks of at
        most :data:`PLAN_IDS` ids (one id all-to-all a chunk; a whole
        BlogCatalog epoch is one chunk), rows gathered from ``tables`` (one
        step ahead with overlap), ``kernel_step(k, rows, plan, rwalks,
        wrow, rneg)`` applied."""
        cfg = self.cfg
        S = rows_all.shape[0]
        u = rows_all[0].numel() + n_pools * cfg.shared_negatives
        chunk = max(1, PLAN_IDS // u)
        cache: dict = {}

        def planned(k):
            c = k // chunk
            if c not in cache:
                n = min(S, (c + 1) * chunk) - c * chunk
                pools = sample_alias(self.accept, self.alias, self.gen,
                                     (n, n_pools, cfg.shared_negatives))
                wrow = (torch.randint(1, cfg.window + 1, (n, n_wrow),
                                      generator=self.gen, device=self.device,
                                      dtype=torch.int32)
                        if n_wrow else [None] * n)
                plans, rw, rn, served = plan_walk_macro_steps(
                    rows_all[c * chunk:c * chunk + n], pools, self.rows_per,
                    cfg.a2a_capacity_slack, self.layout.model_index, self.M,
                    self.model_group)
                self._srv.append(served)
                cache[c] = (plans, rw, wrow, rn)
                cache.pop(c - 2, None)
            plans, rw, wrow, rn = cache[c]
            j = k - c * chunk
            return plans.step(j), rw[j], wrow[j], rn[j]

        def gather(plan):
            return [plan.gather(t) for t in tables]

        def step(k, rows, plan):
            kernel_step(k, rows, *planned(k))

        prefetch_loop(lambda k: planned(k)[0], S, gather, step,
                      self._overlap_on())

    def _o1_rowsharded_scan(self, walks_all: torch.Tensor):
        """One row-sharded O1 pass over this data row's walks [S, B_local,
        L] (``_o1_rowsharded_scan``, ``:493-579``).  Returns (loss, pairs)
        device tensors, this worker's."""
        cfg = self.cfg
        S, B_local, L = walks_all.shape
        b_w, n_groups, n_pools = self._rowsharded_walk_shapes(B_local)
        p = self.params
        tot = torch.zeros(2, device=self.device)
        words = float(B_local * self.workers * L)

        def kernel_step(k, rows, plan, rw, wrow, rn):
            dn, dc, loss, npairs = fused_walk_step_prepped(
                p.node_emb, p.ctx_emb, rows[0], rows[1], plan, rw, wrow, rn,
                self.lr(), self.negw, window=cfg.window,
                pool_refresh=cfg.walk_pool_refresh,
                mxu_bf16=cfg.walk_kernel_bf16)
            apply_deltas_([p.node_emb, p.ctx_emb], [dn, dc],
                          self.data_group)
            self.words_seen += words
            tot.add_(torch.stack([loss, npairs]))

        self._rowsharded_epoch(self._model_slice(walks_all), n_pools,
                               kernel_step, (p.node_emb, p.ctx_emb),
                               n_wrow=n_groups * NWL)
        return tot[0], tot[1]

    def _o1_walks_epoch(self, walks_all: torch.Tensor) -> float:
        if self.M > 1 and self.o1_walk_kernel:
            return self._finish_o1(*self._o1_rowsharded_scan(walks_all))
        return super()._o1_walks_epoch(walks_all)

    def _o1_walks_step(self, walks: torch.Tensor):
        """One O1 macro step from this data row's walks [B_local, L]: at
        M > 1 on the walk kernel a one-step row-sharded pass (a host-fed
        batch, ``_o1_epoch_host`` ``:1363-1432``)."""
        if self.M > 1 and self.o1_walk_kernel:
            return self._o1_rowsharded_scan(walks[None])
        return super()._o1_walks_step(walks)

    def host_feeder(self) -> HostWalkFeeder:
        """This data row's feeder (``_o1_epoch_host``, ``:1363-1430``):
        the walk starts split over the D data rows (``np.array_split``),
        batches of ``B // D`` with ``B = max(D*M, min(batch_walks, starts
        * walks_per_node) // (D*M) * (D*M))``, seed ``seed + 7919 *
        data_index``, so the M ranks of a data row make the same
        batches."""
        if self._host_feeder is None:
            cfg, D, g = self.cfg, self.workers, self.mesh_workers
            di = self.layout.data_index
            v = len(self.walk_starts)
            B = min(cfg.batch_walks, v * cfg.walks_per_node)
            B = max(g, B // g * g)
            nodes = np.array_split(self.walk_starts, D)[di]
            if nodes.size == 0:  # more data rows than starts: walk any
                nodes = self.walk_starts
            self._host_feeder = HostWalkFeeder(
                self.graph, batch=B // D, length=cfg.walk_length,
                seed=self.seed + 7919 * di,
                restart_prob=cfg.restart_prob, nodes=nodes,
                pin_memory=self.device.type == "cuda",
            )
        return self._host_feeder

    # ------------------------------------------------------------------ O2

    def o2_paired_plan(self) -> tuple[int, int]:
        """(global rows per macro step B_r, steps S): ``_o2_rows_global``
        (``:847-870``), B_r rounded up to whole 8-row groups for every
        worker of the mesh."""
        e2 = self._undirected_edges()[0].shape[0]
        edges_step = max(64, min(self.cfg.batch_edges // 2, e2))
        unit = self.mesh_workers * NW
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
        reduce_tied_(ne, new_in, new_out, self.data_group)
        self.words_seen += float(rows.numel() * self.workers)
        return loss, npairs

    def _rowsharded_o2_shapes(self, b_r_local: int | None = None):
        """(edge rows per worker, groups, pools) of the row-sharded paired
        tier (``:874-885``)."""
        if b_r_local is None:
            b_r_local = self.o2_paired_plan()[0] // self.workers
        b_w = max(1, b_r_local // self.M)
        n_groups = -(-b_w // NW)
        return b_w, n_groups, -(-n_groups // self.cfg.walk_pool_refresh)

    def o2_paired_epoch(self) -> float:
        """The paired O2 epoch; at M > 1 row-sharded
        (``_o2_rowsharded_scan``, ``:1027-1108``): this data row's packed
        edge rows sliced over 'model', each worker's endpoint rows
        gathered into ONE compact tied table (half O1's exchange), K5 on
        two copies of it and ``dn + dc`` routed back to the owners."""
        if self.M == 1:
            return super().o2_paired_epoch()
        cfg = self.cfg
        B_r, S = self.o2_paired_plan()
        uu, vv = self._undirected_edges()
        e2 = uu.shape[0]
        perm = self._shuffle(e2)
        idx = perm[torch.arange(S * B_r * 64, device=self.device) % e2]
        rows = self._mine(torch.stack([uu[idx], vv[idx]], 1).reshape(
            S, B_r, 128))
        _, _, n_pools = self._rowsharded_o2_shapes(rows.shape[1])
        ne = self.params.node_emb
        tot = torch.zeros(2, device=self.device)
        words = float(rows.shape[1] * self.workers * 128)

        def kernel_step(k, got, plan, rw, wrow, rn):
            dn, _, loss, npairs = fused_walk_step_prepped(
                ne, None, got[0], None, plan, rw, wrow, rn,
                self.lr() * cfg.alpha, self.negw, window=1,
                pool_refresh=cfg.walk_pool_refresh,
                mxu_bf16=cfg.walk_kernel_bf16, paired=True)
            apply_deltas_([ne], [dn], self.data_group)
            self.words_seen += words
            tot.add_(torch.stack([loss, npairs]))

        self._rowsharded_epoch(self._model_slice(rows), n_pools, kernel_step,
                               (ne,))
        return self._finish_o2(tot[0], tot[1])

    # ------------------------------------------------------- GMM, O3, tiers

    def fit_gmm(self, resp0: torch.Tensor | None = None) -> float:
        """Distributed EM (``losses.gmm.gmm_em_fit_sharded``) over the
        whole mesh: each rank a chunk of its model shard's rows, the
        moments summed over both axes; pad rows get ``pi = 0``
        (``:1297-1327``, ``:1621-1629``)."""
        cfg = self.cfg
        p = self.params
        mask = None if self.M == 1 else self._pad_mask()
        out = gmm_em_fit_sharded(
            p.node_emb, mask, p.num_communities, self.host_gen, self.group,
            n_init=cfg.gmm_n_init, max_iter=cfg.gmm_max_iter,
            reg_covar=cfg.reg_covar, tol=cfg.gmm_tol, resp0=resp0,
            model=self.M,
        )
        p.centroid.copy_(out["means"])
        p.chol_cov.copy_(out["chol"])
        p.inv_cov.copy_(out["inv_cov"])
        resp = out["resp"]
        p.pi.copy_(resp if mask is None else resp * mask[:, None])
        return float(out["log_likelihood"])

    def o3_step(self) -> torch.Tensor:
        """O3 on this rank's rows (no communication); at M > 1 the loss is
        summed over 'model' (``:1268-1293``)."""
        loss = super().o3_step()
        if self.M == 1:
            return loss
        return all_reduce_(loss.reshape(1), self.model_group)[0]

    def o1_tier(self) -> str:
        """The JAX sharded trainer's name of the O1 tier (``:1466-1487``)."""
        if self.o1_walk_kernel:
            return ("walk-kernel-rowsharded" if self.M > 1
                    else "walk-kernel-dp")
        return self._xla_tier()

    def o2_tier(self) -> str:
        """The JAX sharded trainer's name of the O2 tier (``:1008-1025``)."""
        if self.o2_star:
            return "star-o2-dp"
        if self.o2_paired:
            return ("walk-kernel-paired-rowsharded" if self.M > 1
                    else "walk-kernel-paired-dp")
        return self._xla_tier()

    def _xla_tier(self) -> str:
        if self.cfg.negative_mode != "shared":
            return "xla-per-pair"
        return ("xla-a2a" if self.row_exchange == "a2a" and self.M > 1
                else "xla-psum")

    def exchange_overlap_ab(self, epochs: int = 1, phase: str = "o1"
                            ) -> dict:
        """One warmed O1 (or O2) epoch, timed with the one-step row
        prefetch on and off, each on a fresh trainer of this mesh and
        configuration (this trainer is untouched; ``:1489-1528``):
        ``{"overlap_on_ms", "overlap_off_ms", "exchange_hidden_ms"}``.
        Every rank must call it.  Raises at model 1."""
        if self.M <= 1:
            raise ValueError("no row exchange at model=1 (psum-only mesh)")
        if phase not in ("o1", "o2"):
            raise ValueError(f"phase must be o1|o2, got {phase!r}")

        def timed(cfg):
            tr = type(self)(self._orig_graph, cfg, self.layout, self.device,
                            self.seed)
            epoch = tr.o1_epoch if phase == "o1" else tr.o2_epoch
            epoch()  # warm
            tr._sync()
            t0 = time.perf_counter()
            for _ in range(epochs):
                epoch()
            tr._sync()
            return (time.perf_counter() - t0) / epochs * 1e3

        on = timed(self.cfg.replace(overlap_exchange=True))
        off = timed(self.cfg.replace(overlap_exchange=False))
        return {"overlap_on_ms": on, "overlap_off_ms": off,
                "exchange_hidden_ms": off - on}

    # ---------------------------------------------------------- persistence

    def _meta(self) -> dict:
        return {"data": self.workers, "model": self.M,
                "v_real": self.v_real,
                "interleave": int(self._perm is not None)}

    def save_checkpoint(self, path) -> None:
        """This rank's file ``<path>.proc<rank>.npz`` of a sharded
        checkpoint (``:1631-1657``): at M > 1 its row blocks as
        ``<name>@<row_start>``; then a barrier, so no rank reads the
        checkpoint before every file is written."""
        persist.save_checkpoint_sharded(
            path, self.params, self.words_seen, self.seed, self.rank,
            self.mesh_workers, self._meta(), gen=self.gen,
            host_gen=self.host_gen,
            rows=None if self.M == 1 else (
                self.layout.row_block(self.v_pad)[0], self.v_pad),
            data_gen=None if self.M == 1 else self.data_gen)
        if dist.is_available() and dist.is_initialized():
            dist.barrier(self.group)

    def load_checkpoint(self, path) -> dict:
        """Restore a checkpoint of either package (``:1659-1763``): a
        sharded one saved on this mesh (the same data and model sizes and
        row layout) from this rank's own file, with its generators (at
        M > 1 the data row's stream too; bit-exact resume on the CPU); any other (another mesh, the
        single-device form) merged whole by the elastic path and laid out
        for this mesh: the saved interleave undone, this mesh's applied,
        the streams left as they are.  Returns which generators were
        restored."""
        meta = (persist.load_checkpoint_meta(path, self.rank)
                or persist.load_checkpoint_meta(path, 0))
        cfg = self.cfg
        same = (meta.get("process_count") == self.mesh_workers
                and meta.get("data") == self.workers
                and meta.get("model", 1) == self.M
                and meta.get("interleave", 0) == int(self._perm is not None))
        shape = (self.v_real, cfg.dim, cfg.num_communities)
        if same:
            params, self.words_seen, restored = \
                persist.load_checkpoint_sharded(
                    path, self.rank, self.mesh_workers, self.device,
                    gen=self.gen, host_gen=self.host_gen,
                    shape=None if self.M > 1 else shape,
                    row_start=(self.layout.row_block(self.v_pad)[0]
                               if self.M > 1 else None),
                    data_gen=None if self.M == 1 else self.data_gen)
            self.params = params
            return restored
        leaves, words = persist.load_logical(path, shape)
        self.words_seen = words
        self.params = from_numpy(self._laid_out(leaves), self.device)
        return {"gen": False, "host_gen": False}

    def _laid_out(self, leaves: dict) -> dict:
        """Logical (node-order) leaves in this trainer's rows: interleaved
        (when it interleaves), padded to V_pad, this rank's row block."""
        a, b = self.layout.row_block(self.v_pad)
        out = {}
        for k in FIELDS:
            x = np.asarray(leaves[k])
            if k in persist.ROW_LEAVES:
                rows = np.zeros((self.v_pad,) + x.shape[1:], x.dtype)
                if self._perm is not None:
                    rows[self._perm] = x
                else:
                    rows[:self.v_real] = x
                x = rows[a:b]
            out[k] = x
        return out

    # ------------------------------------------------------------------ views

    def _gathered(self, t: torch.Tensor) -> np.ndarray:
        """The whole row table ``t`` in original node order: gathered over
        'model' (every rank of the model group must call it), pad rows
        dropped, the interleave undone (``:1778-1790``)."""
        if self.M > 1:
            t = all_gather_(t, self.model_group)
        a = t[:self.v_real].cpu().numpy()
        return a[self._perm] if self._perm is not None else a.copy()

    def embeddings(self) -> np.ndarray:
        return self._gathered(self.params.node_emb)

    def communities(self) -> np.ndarray:
        return self._gathered(self.params.pi.argmax(1))
