"""Alternating ComE trainer: pretrain -> [GMM fit -> O1 -> O2 -> O3 -> eval].

Port of ``come_tpu/trainer/come.py`` for one device, with its single-device
O1/O2 dispatch:

* O1 through the walk-banded kernel K1 (``ops/walk_sgns.py``; K1b with
  ``walk_kernel_bf16``) when the JAX trainer's gates allow it: shared
  negatives, ``walk_length <= 128``, no subsampling, and a graph inside the
  collision envelope.  With ``walk_gen="kernel"``, no restarts and fresh
  walks every epoch, the walks are generated inside the kernel (K4).  Past
  the JAX package's 48 MiB f32-table line, with
  ``walk_kernel_bf16_tables``, the kernel runs on bf16 working tables (K3,
  :func:`o1_table_dtype`).
  Otherwise the micro-batched tier: window pairs from ``skipgram_pairs``,
  applied in micro-steps of ``batch_pairs`` through K6 (``ops/sgns.py``,
  shared negatives) or the per-pair step (``losses/sgns.py``).
* O2 through the star kernel K2 (``ops/star_sgns.py``; K2b with
  ``walk_kernel_bf16``) for ``o2_mode`` auto/star with shared negatives
  inside the envelope, or the walk kernel's paired edge mode K5 for
  ``o2_mode="paired"``; otherwise per arc in batches of ``batch_edges``
  through the same micro-batched tier on the tied table: K7 or the tied
  per-pair step.

Where the JAX trainer on a TPU would take a banded or XLA-block tier
(tables past its VMEM budgets, or ``walk_length > 128`` inside the banded
envelope), the port takes K6/K7: its tables live in HBM at every V and those
tiers are not ported (ROADMAP decision 1).  The GMM fit and the O3 step run
as torch ops.  The linear LR decay ``max(min_lr, lr * (1 - words /
total))`` is kept exactly; ``words_seen`` is a host float because every
step advances it by a fixed count.  Losses and pair counts stay on the
device until one sync per epoch.

With ``corpus="host"`` the walks come from the C++ host walker
(``native/``): a feeder thread keeps batches ready in pinned host memory,
each copied to the card without blocking and trained through the same O1
step (K1, K1b or K3; otherwise the micro-batched tier) while the walker
makes the next (``_o1_epoch_host``, ``trainer/come.py:751-783``).

Randomness comes from two ``torch.Generator``s seeded from ``seed``: one on
the device (init, walks, window and keep draws, negatives and pools, the
star-row and arc shuffles) and one on the host (the epoch's walk-start
permutation, the GMM init).  The host corpus's walks come from the
feeder's own numpy and splitmix64 streams, the JAX package's.  JAX's
threefry streams are not reproduced; the tests feed both packages the same
draws through the ``*_step`` methods.  Checkpoints (``iohelpers/``) hold
the parameters, ``words_seen`` and both generators' states.

``pallas="never"`` (the JAX package's XLA banded and block tiers) raises
``NotImplementedError``: ROADMAP decision 1 does not port those tiers.
"""

from __future__ import annotations

import contextlib
import math
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from come_tpu_torch.config import ComEConfig
from come_tpu_torch.evaluation.metrics import nmi_score
from come_tpu_torch.graphs.csr import CSRGraph
from come_tpu_torch.iohelpers import persist
from come_tpu_torch.losses.community import community_loss, community_sgd_step
from come_tpu_torch.losses.gmm import fit_communities
from come_tpu_torch.losses.gmm import release_plans as gmm_release_plans
from come_tpu_torch.losses.sgns import sgns_sgd_step
from come_tpu_torch.models.state import init_params
from come_tpu_torch.native import HostWalkFeeder
from come_tpu_torch.ops.sgns import (
    fused_sgns_scan,
    fused_sgns_scan_tied,
    fused_sgns_step,
    fused_sgns_step_tied,
)
from come_tpu_torch.ops.star_sgns import star_sgns_step
from come_tpu_torch.ops.walk_sgns import (
    NW,
    NWL,
    walk_sgns_gen_step,
    walk_sgns_step,
)
from come_tpu_torch.sampling.alias import (
    build_alias_table,
    sample_alias,
    unigram_weights,
)
from come_tpu_torch.sampling.stars import (
    PAD_META,
    build_star_layout,
    star_layout_stats,
)
from come_tpu_torch.sampling.walks import random_walks
from come_tpu_torch.sampling.windows import (
    skipgram_pairs,
    subsample_keep_probs,
)


def _decayed_lr(words_seen, total_words, lr0, min_lr):
    frac = 1.0 - words_seen / max(total_words, 1.0)
    return max(min_lr, lr0 * frac)


def _unsupported(cfg: ComEConfig) -> str | None:
    """The first setting the port does not have, with its ROADMAP item."""
    checks = [
        (cfg.pallas == "never",
         "pallas='never', the JAX package's XLA banded/block tiers, which "
         "ROADMAP decision 1 does not port"),
    ]
    for bad, what in checks:
        if bad:
            return what
    return None


def _in_envelope(slots_per_unit: float, num_nodes: int,
                 workers: int = 1) -> bool:
    """The kernels' collision envelope (come_tpu/trainer/come.py:166-180,
    :859-881): one synchronous update must not hit a row more than ~16
    times on average.  Under data parallelism every worker's unit lands on
    the table in one synchronous step, so the envelope narrows by the
    worker count (come_tpu/parallel/sharded.py:455-460, :950-952)."""
    return 2.0 * slots_per_unit * workers / max(num_nodes, 1) <= 16.0


def o1_on_walk_kernel(num_nodes: int, cfg: ComEConfig,
                      workers: int = 1) -> bool:
    """Whether O1 takes the walk kernel (``_use_walk_kernel``,
    come_tpu/trainer/come.py:149-180, minus its VMEM gate): shared
    negatives, walks of at most 128, no subsampling, and the collision
    envelope of ``workers`` data-parallel ranks."""
    return (
        cfg.negative_mode == "shared" and cfg.walk_length <= 128
        and cfg.down_sample <= 0
        and _in_envelope(NW * cfg.walk_length * (cfg.window + 1) / 2,
                         num_nodes, workers)
    )


# f32 walk tables past this many bytes go bf16 (the JAX package's VMEM tier)
WALK_F32_TABLE_BYTES = 48 * 1024 * 1024


def o1_table_dtype(num_nodes: int, dim: int, cfg: ComEConfig,
                   workers: int = 1) -> torch.dtype:
    """The O1 walk tables' dtype: bfloat16 (K3) iff O1 takes the walk
    kernel, ``walk_kernel_bf16_tables`` is set and f32 tables would pass
    ``WALK_F32_TABLE_BYTES``; float32 otherwise.

    Mirrors ``ComETrainer._walk_table_dtype`` (come_tpu/trainer/
    come.py:204-226), which picks bf16 by the same 48 MiB line where bf16
    tables still fit the TPU's VMEM, V in (98 304, 196 608] at d = 128,
    and leaves the kernel past that.  The card runs one kernel at every V
    (ROADMAP decision 1), so bf16 tables carry on above 196 608."""
    big = num_nodes * dim * 4 > WALK_F32_TABLE_BYTES
    if o1_on_walk_kernel(num_nodes, cfg, workers) \
            and cfg.walk_kernel_bf16_tables \
            and big:
        return torch.bfloat16
    return torch.float32


class ComETrainer:
    """Single-device trainer.  ``device`` is where the tables and every
    kernel live ("cuda" or "cpu"; on the CPU the kernels' plain versions
    run)."""

    # data-parallel ranks whose steps make one global step (the
    # ShardedComETrainer of parallel/sharded.py sets it): words_seen
    # advances by the global step's words and micro-steps split by it
    workers = 1
    # every worker of the mesh (data x model): walk batches round to it and
    # the collision envelope narrows by it
    mesh_workers = 1

    def __init__(self, graph: CSRGraph, config: ComEConfig, device,
                 seed: int | None = None):
        why = _unsupported(config)
        if why is not None:
            raise NotImplementedError(f"not ported yet: {why}")
        if config.down_sample > 0 and config.negative_mode == "shared":
            # as the JAX trainer warns (trainer/come.py:77-101): never a
            # silent change of O1 tier
            import warnings

            warnings.warn(
                f"down_sample={config.down_sample} takes O1 off the walk "
                "kernel K1 (its in-kernel pair masks do not model "
                "occurrence dropping) to the micro-batched tier, K6 per "
                "micro-step, whose pair masks apply the keep probabilities "
                "exactly.  O2 is unaffected (the edge pass does not "
                "subsample).  Use down_sample=0 (the reference default) "
                "for K1.",
                stacklevel=2,
            )
        self.graph = graph
        self.cfg = config
        self.device = torch.device(device)
        seed = config.seed if seed is None else seed
        self.seed = seed
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        # the walks, window pairs and per-pair negatives: on one device the
        # same stream (the row-sharded trainer gives each data row its own)
        self.data_gen = self.gen
        self.host_gen = torch.Generator().manual_seed(seed)
        self.csr = graph.to_device(self.device)
        degrees = graph.degrees
        accept, alias = build_alias_table(unigram_weights(degrees))
        self.accept = torch.as_tensor(accept, device=self.device)
        self.alias = torch.as_tensor(alias, device=self.device)
        self.keep = (
            torch.as_tensor(subsample_keep_probs(degrees, config.down_sample),
                            device=self.device)
            if config.down_sample > 0 else None
        )
        self.arc_src, self.arc_dst = (
            torch.as_tensor(a, device=self.device) for a in graph.arcs()
        )
        # walk starts skip isolated nodes (come_tpu/trainer/come.py:105-119:
        # a stationary walk sums ~L*W copies of one self-pair per group)
        ws = np.flatnonzero(degrees > 0).astype(np.int32)
        self.walk_starts = (
            ws if ws.size else np.arange(graph.num_nodes, dtype=np.int32)
        )
        self.params = init_params(
            graph.num_nodes, config.dim, config.num_communities, self.gen,
            self.device,
        )
        self.words_seen = 0.0
        self.total_words = float(self._word_budget())
        self.negw = config.negative / config.shared_negatives
        self._history: list[dict] = []
        self._walk_cache: torch.Tensor | None = None
        self._host_feeder: HostWalkFeeder | None = None
        self._o1_epochs_done = 0
        self._o1_work: tuple[torch.Tensor, torch.Tensor] | None = None
        self._o1_bufs: tuple[torch.Tensor, torch.Tensor] | None = None
        self._star_rows: tuple[torch.Tensor, torch.Tensor] | None = None
        self._und_edges: tuple[torch.Tensor, torch.Tensor] | None = None
        self.last_o1_pairs = 0.0
        self.last_o2_pairs = 0.0
        # the tiers the JAX trainer picks on a TPU, minus the ones ROADMAP
        # decision 1 leaves unported: K1 (_use_walk_kernel, :149-180) or
        # the micro-batched tier (:619-630); K2 (_use_star_o2, :862-881) or
        # per arc (_o2_epoch, :1136-1144).  JAX's VMEM gates are not
        # ported: the tables live in HBM at every V.  So K1/K2 take every V
        # (no 48 MB tier, :204-226), and K6/K7 take the shared micro-steps
        # at every V (no 28 MB-per-table gate, :242-248), including what
        # JAX sends past that gate to its XLA block path, and long walks
        # that fit JAX's banded envelope (:182-202).
        V, wk = graph.num_nodes, self.mesh_workers
        shared = config.negative_mode == "shared"
        self.o1_walk_kernel = o1_on_walk_kernel(V, config, wk)
        self.o1_table_dtype = o1_table_dtype(V, config.dim, config, wk)
        self.o2_star = (
            shared and config.o2_mode in ("auto", "star")
            and _in_envelope(NWL, V, wk)
        )
        # in-kernel walks (_use_walk_kernel_gen, :380-394, taken at :696
        # with fresh walks every epoch, never with the host corpus, :683);
        # its CSR side budgets are VMEM's
        self.o1_gen = (
            self.o1_walk_kernel and config.walk_gen == "kernel"
            and config.corpus != "host"
            and config.restart_prob == 0.0 and config.walk_regen_epochs == 1
        )
        # the walk kernel's paired edge mode (_use_walk_kernel_o2,
        # :841-860), checked after the star tier as at :1095-1116
        self.o2_paired = (
            not self.o2_star and shared
            and config.o2_mode in ("auto", "paired")
            and _in_envelope(NWL, V, wk)
        )

    def tier_kernels(self) -> tuple[str | None, str | None]:
        """The kernels of the O1 and O2 tiers on the card, by their names
        in ``ops/walk_sgns.py`` (K1, K1b, K3, K4, K5, K2, K2b, K6, K7);
        None where the tier runs torch ops (the per-pair step)."""
        cfg = self.cfg
        bf16 = cfg.walk_kernel_bf16
        micro = cfg.negative_mode == "shared"
        if not self.o1_walk_kernel:
            o1 = "K6" if micro else None
        elif self.o1_gen:
            o1 = "K4"
        elif self.o1_table_dtype == torch.bfloat16:
            o1 = "K3"
        else:
            o1 = "K1b" if bf16 else "K1"
        if self.o2_star:
            o2 = "K2b" if bf16 else "K2"
        elif self.o2_paired:
            o2 = "K1b" if bf16 else "K5"
        else:
            o2 = "K7" if micro else None
        return o1, o2

    def _word_budget(self) -> float:
        """Total center-word count for the global linear LR decay."""
        cfg = self.cfg
        v, e = len(self.walk_starts), self.graph.num_arcs
        o1_epochs = cfg.pretrain_epochs + cfg.outer_iters * cfg.o1_epochs_per_iter
        o2_epochs = cfg.outer_iters * cfg.o2_epochs_per_iter
        return (
            o1_epochs * v * cfg.walks_per_node * cfg.walk_length
            + o2_epochs * e
        )

    def lr(self) -> float:
        cfg = self.cfg
        return _decayed_lr(self.words_seen, self.total_words, cfg.lr, cfg.min_lr)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def _update(self, *tables):
        """Around one step that updates ``tables`` in place: nothing on one
        device; the data-parallel trainer sums every rank's update here."""
        yield

    def _scans(self) -> bool:
        """Whether a shared-negative macro batch runs as one scan: when
        :meth:`_update` is this class's no-op (the data-parallel trainer
        sums every rank's update after each micro-step, so it loops)."""
        return type(self)._update is ComETrainer._update

    def _shuffle(self, n: int) -> torch.Tensor:
        """A permutation of ``n`` on the device (star rows, arcs, edges)."""
        return torch.randperm(n, generator=self.gen, device=self.device)

    def _mine(self, batch: torch.Tensor) -> torch.Tensor:
        """This trainer's columns of a [S, B, ...] epoch batch: all of them
        on one device."""
        return batch

    # ------------------------------------------------------------- O1 (walks)

    def _o1_draws(self, B: int):
        """Window draws and negative pools for one macro step of B walks."""
        cfg = self.cfg
        G = -(-B // NW)
        n_pools = -(-G // cfg.walk_pool_refresh)
        wrow = torch.randint(
            1, cfg.window + 1, (G * NWL,), generator=self.gen,
            device=self.device, dtype=torch.int32,
        )
        pools = sample_alias(
            self.accept, self.alias, self.gen, (n_pools, cfg.shared_negatives)
        )
        return wrow, pools

    @contextlib.contextmanager
    def _o1_tables(self):
        """The walk kernel's O1 tables: the f32 params, or with bf16 tables
        (K3) working copies made by round to nearest even, as the JAX
        package's ``.astype`` at the start of an O1 epoch
        (``trainer/come.py:528-536``, gen mode ``:413-419``), and copied
        back into the f32 params on exit (``:638-642``, ``:448-452``).
        GMM, O2 and O3 read only the f32 params.  Re-entrant: a step inside
        an epoch uses the epoch's copies.  The copies go into two bf16
        buffers kept across epochs, so the walk kernel's launch plan,
        whose recording holds the tables' addresses, records once."""
        p = self.params
        if self._o1_work is not None:
            yield self._o1_work
            return
        if self.o1_table_dtype != torch.bfloat16:
            yield p.node_emb, p.ctx_emb
            return
        if self._o1_bufs is None:
            self._o1_bufs = tuple(torch.empty_like(t, dtype=torch.bfloat16)
                                  for t in (p.node_emb, p.ctx_emb))
        self._o1_work = self._o1_bufs
        for b, t in zip(self._o1_work, (p.node_emb, p.ctx_emb)):
            b.copy_(t)  # round to nearest even, as .to(torch.bfloat16)
        try:
            yield self._o1_work
        finally:
            p.node_emb.copy_(self._o1_work[0])
            p.ctx_emb.copy_(self._o1_work[1])
            self._o1_work = None

    def _sr_seed(self) -> int | None:
        """A step's stochastic-rounding seed for bf16 tables, drawn on the
        host so no step waits for the card; None for f32 tables."""
        if self.o1_table_dtype != torch.bfloat16:
            return None
        return int(torch.randint(2**32, (), generator=self.host_gen))

    def o1_step(self, walks: torch.Tensor, wrow: torch.Tensor,
                pools: torch.Tensor):
        """One O1 macro step from explicit walks [B, L], window draws and
        pools (``trainer/come.py:549-590``, walk-kernel branch).  Returns
        (loss, n_pairs) as device tensors."""
        cfg = self.cfg
        with self._o1_tables() as (ne, ce), self._update(ne, ce):
            _, _, loss, npairs = walk_sgns_step(
                ne, ce, walks, wrow, pools, self.lr(), self.negw,
                window=cfg.window, pool_refresh=cfg.walk_pool_refresh,
                mxu_bf16=cfg.walk_kernel_bf16, sr_seed=self._sr_seed(),
            )
        self.words_seen += float(walks.shape[0] * self.workers
                                 * cfg.walk_length)
        return loss, npairs

    def _gen_bits(self, n: int) -> torch.Tensor:
        """n random 32-bit values as int32 (every bit drawn, bit 31 too: a
        non-negative draw would send every hop to the first half of its
        neighbour list)."""
        return torch.randint(-2**31, 2**31, (n,), generator=self.gen,
                             device=self.device, dtype=torch.int32)

    def o1_gen_step(self, starts: torch.Tensor, bits: torch.Tensor,
                    wrow: torch.Tensor, pools: torch.Tensor):
        """One O1 macro step with in-kernel walks (``_o1_epoch_gen``,
        ``trainer/come.py:421-443``): ``starts`` [B], ``bits`` [G*1024]
        int32.  Returns (loss, n_pairs) as device tensors."""
        cfg = self.cfg
        with self._o1_tables() as (ne, ce):
            _, _, loss, npairs = walk_sgns_gen_step(
                ne, ce, starts, bits, self.csr.indptr, self.csr.indices,
                wrow, pools, self.lr(), self.negw,
                walk_length=cfg.walk_length, window=cfg.window,
                pool_refresh=cfg.walk_pool_refresh,
                mxu_bf16=cfg.walk_kernel_bf16, sr_seed=self._sr_seed(),
            )
        self.words_seen += float(starts.shape[0] * cfg.walk_length)
        return loss, npairs

    def _sgns_microbatched(self, emb_in, emb_out, c, x, negs, m, lr,
                           tie_tables: bool, compact: bool = False,
                           pools: torch.Tensor | None = None):
        """Apply one macro batch of pairs as sequential micro-steps of
        ``batch_pairs`` (``trainer/come.py:265-378``): K6 (K7 with
        ``tie_tables``) against one fresh pool of ``shared_negatives`` per
        micro-step, or the per-pair step with ``negs`` [..., negative].

        ``c``, ``x``, ``m`` are any shape of P pairs; ``pools`` int
        [n_micro, KP] replaces the pool draws.  The tables are updated in
        place.  With shared negatives and no update rule around each
        micro-step (:meth:`_scans`) the macro batch is one call of
        ``fused_sgns_scan`` (one WHILE-graph launch on the card, the JAX
        trainer's ``lax.scan`` at ``:350``); else a loop of micro-steps,
        each inside :meth:`_update`.  Returns (loss, n_pairs) as device
        tensors."""
        cfg = self.cfg
        P = c.numel()
        c, x, m = c.reshape(P), x.reshape(P), m.reshape(P)
        if negs is not None:
            negs = negs.reshape(P, cfg.negative)
        if compact and cfg.compact_budget and cfg.compact_budget < 1.0:
            # stable partition: valid pairs first, then cut to the budget
            keep = torch.argsort((m == 0).to(torch.uint8), stable=True)
            keep = keep[:int(P * cfg.compact_budget)]
            c, x, m = c[keep], x[keep], m[keep]
            if negs is not None:
                negs = negs[keep]
            P = keep.numel()
        mb = max(1, min(cfg.batch_pairs // self.workers, P))
        n_micro = math.ceil(P / mb)
        pad = n_micro * mb - P
        c, x = F.pad(c, (0, pad)), F.pad(x, (0, pad))
        m = F.pad(m.to(torch.float32), (0, pad))
        tot_loss = torch.zeros((), device=self.device)
        tot_pairs = torch.zeros((), device=self.device)
        shared = cfg.negative_mode == "shared"
        if shared and pools is None:
            pools = sample_alias(self.accept, self.alias, self.gen,
                                 (n_micro, cfg.shared_negatives))
        if not shared:
            negs = F.pad(negs, (0, 0, 0, pad))
        tables = (emb_in,) if tie_tables else (emb_in, emb_out)
        if shared and self._scans():
            # the whole batch as one launch: the JAX trainer's lax.scan
            c2, x2, m2 = (t.reshape(n_micro, mb) for t in (c, x, m))
            kw = dict(tile_pairs=cfg.pallas_tile_pairs)
            if tie_tables:
                _, loss, npairs = fused_sgns_scan_tied(
                    emb_in, c2, x2, pools, m2, lr, self.negw, **kw)
            else:
                _, _, loss, npairs = fused_sgns_scan(
                    emb_in, emb_out, c2, x2, pools, m2, lr, self.negw, **kw)
            return loss, npairs
        for i in range(n_micro):
            s = slice(i * mb, (i + 1) * mb)
            with self._update(*tables):
                if shared and tie_tables:
                    _, loss, npairs = fused_sgns_step_tied(
                        emb_in, c[s], x[s], pools[i], m[s], lr, self.negw,
                        tile_pairs=cfg.pallas_tile_pairs,
                    )
                elif shared:
                    _, _, loss, npairs = fused_sgns_step(
                        emb_in, emb_out, c[s], x[s], pools[i], m[s], lr,
                        self.negw, tile_pairs=cfg.pallas_tile_pairs,
                    )
                else:
                    _, _, loss, npairs = sgns_sgd_step(
                        emb_in, emb_out, c[s], x[s], negs[s], m[s], lr,
                        tie_tables=tie_tables, max_exp=cfg.max_exp,
                    )
            tot_loss += loss
            tot_pairs += npairs
        return tot_loss, tot_pairs

    def o1_pairs_step(self, walks: torch.Tensor):
        """One O1 macro step through the micro-batched tier
        (``trainer/come.py:619-630``): the window pairs of ``walks``
        [B, L], per-pair negatives in per-pair mode, then
        :meth:`_sgns_microbatched`.  Returns (loss, n_pairs) tensors."""
        cfg = self.cfg
        c, x, m = skipgram_pairs(walks, cfg.window, self.data_gen, self.keep)
        negs = None
        if cfg.negative_mode != "shared":
            negs = sample_alias(self.accept, self.alias, self.data_gen,
                                tuple(c.shape) + (cfg.negative,))
        p = self.params
        loss, npairs = self._sgns_microbatched(
            p.node_emb, p.ctx_emb, c, x, negs, m, self.lr(),
            tie_tables=False, compact=True,
        )
        self.words_seen += float(walks.shape[0] * self.workers
                                 * cfg.walk_length)
        return loss, npairs

    def _epoch_starts(self) -> torch.Tensor:
        """This epoch's walk origins [S, B]: every start walks_per_node
        times, shuffled, the tail batch wrapped; B rounds down to whole
        columns of the data-parallel ranks, of which this trainer keeps its
        own (come_tpu/parallel/sharded.py:1432-1457)."""
        cfg = self.cfg
        n_starts = len(self.walk_starts) * cfg.walks_per_node
        W = self.mesh_workers
        B = min(cfg.batch_walks, n_starts)
        B = max(W, B // W * W)
        S = math.ceil(n_starts / B)
        starts = torch.as_tensor(np.tile(self.walk_starts, cfg.walks_per_node))
        perm = starts[torch.randperm(n_starts, generator=self.host_gen)]
        perm = perm[torch.arange(S * B) % n_starts]
        return self._mine(perm.reshape(S, B)).to(self.device)

    def _gen_epoch_walks(self, starts: torch.Tensor) -> torch.Tensor:
        S, B = starts.shape
        L = self.cfg.walk_length
        walks = random_walks(
            self.csr, starts.reshape(S * B), L, self.data_gen,
            restart_prob=self.cfg.restart_prob,
        )
        return walks.reshape(S, B, L)

    def o1_epoch(self) -> float:
        """One pass of ``walks_per_node`` walks from every start node; the
        epoch's corpus is generated in one call, or reused when
        ``walk_regen_epochs != 1``, or generated step by step inside the
        kernel when ``o1_gen`` (``trainer/come.py:680-729``), or fed from
        the host walker with ``corpus="host"``."""
        cfg = self.cfg
        if cfg.corpus == "host":
            return self._o1_epoch_host()
        starts = self._epoch_starts()
        if self.o1_gen:
            return self._o1_epoch_gen(starts)
        if cfg.walk_regen_epochs != 1:
            regen = self._walk_cache is None or (
                cfg.walk_regen_epochs > 0
                and self._o1_epochs_done % cfg.walk_regen_epochs == 0
            )
            if regen:
                self._walk_cache = self._gen_epoch_walks(starts)
            walks_all = self._walk_cache
        else:
            walks_all = self._gen_epoch_walks(starts)
        self._o1_epochs_done += 1
        return self._o1_walks_epoch(walks_all)

    def _o1_walks_epoch(self, walks_all: torch.Tensor) -> float:
        """Train the epoch's walks [S, B, L] step by step."""
        tot_loss = torch.zeros((), device=self.device)
        tot_pairs = torch.zeros((), device=self.device)
        with self._o1_tables():
            for walks in walks_all:
                loss, npairs = self._o1_walks_step(walks)
                tot_loss += loss
                tot_pairs += npairs
        return self._finish_o1(tot_loss, tot_pairs)

    def _o1_walks_step(self, walks: torch.Tensor):
        """One O1 macro step from walks [B, L] (``_o1_walks_step``,
        ``trainer/come.py:785-836``): the walk kernel with fresh window
        draws and pools, or the micro-batched tier."""
        if self.o1_walk_kernel:
            wrow, pools = self._o1_draws(walks.shape[0])
            return self.o1_step(walks, wrow, pools)
        return self.o1_pairs_step(walks)

    def _o1_epoch_gen(self, starts: torch.Tensor) -> float:
        """O1 epoch through K4 (``_o1_epoch_gen``, ``trainer/come.py:
        396-456``): each macro step draws G*1024 bits, the window draws and
        the pools; the kernel walks from ``starts`` [S, B]."""
        self._o1_epochs_done += 1
        G = -(-starts.shape[1] // NW)
        tot_loss = torch.zeros((), device=self.device)
        tot_pairs = torch.zeros((), device=self.device)
        with self._o1_tables():
            for st in starts:
                bits = self._gen_bits(G * NWL)
                wrow, pools = self._o1_draws(st.shape[0])
                loss, npairs = self.o1_gen_step(st, bits, wrow, pools)
                tot_loss += loss
                tot_pairs += npairs
        return self._finish_o1(tot_loss, tot_pairs)

    def host_feeder(self) -> HostWalkFeeder:
        """The host corpus's feeder, made at first use: batches of
        ``min(batch_walks, len(walk_starts))`` walks from the walk starts,
        seeded with the trainer's seed, pinned when the trainer is on a
        CUDA card."""
        if self._host_feeder is None:
            cfg = self.cfg
            self._host_feeder = HostWalkFeeder(
                self.graph, batch=min(cfg.batch_walks, len(self.walk_starts)),
                length=cfg.walk_length, seed=self.seed,
                restart_prob=cfg.restart_prob, nodes=self.walk_starts,
                pin_memory=self.device.type == "cuda",
            )
        return self._host_feeder

    def _o1_epoch_host(self) -> float:
        """Host-corpus O1 epoch (``_o1_epoch_host``, ``trainer/come.py:
        751-783``): ``ceil(V * walks_per_node / B)`` feeder batches, each
        copied to the device without blocking and trained by the O1 step
        the trainer's tier takes, while the feeder's threads make the next
        batches.  Losses stay on the device until the epoch ends."""
        feeder = self.host_feeder()
        n_batches = math.ceil(len(self.walk_starts) * self.cfg.walks_per_node
                              / (feeder.batch * self.workers))
        self._o1_epochs_done += 1
        tot_loss = torch.zeros((), device=self.device)
        tot_pairs = torch.zeros((), device=self.device)
        with self._o1_tables():
            for _ in range(n_batches):
                walks = next(feeder).to(self.device, non_blocking=True)
                loss, npairs = self._o1_walks_step(walks)
                tot_loss += loss
                tot_pairs += npairs
        return self._finish_o1(tot_loss, tot_pairs)

    def close(self) -> None:
        """Stop the host corpus's feeder thread, if one was started."""
        if self._host_feeder is not None:
            self._host_feeder.close()
            self._host_feeder = None

    def _finish_o1(self, tot_loss, tot_pairs) -> float:
        loss, pairs = torch.stack([tot_loss, tot_pairs]).tolist()
        self.last_o1_pairs = pairs
        return loss / max(pairs, 1.0)

    # ------------------------------------------------------------- O2 (edges)

    def _star_layout(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The static star slot/meta rows [NR, 128], built once
        (``trainer/come.py:883-905``)."""
        if self._star_rows is None:
            u, v = self.graph.edges_undirected()
            slots, meta = build_star_layout(u, v, self.graph.num_nodes)
            self._star_pairs = star_layout_stats(slots, meta)["pairs"]
            self._star_rows = (
                torch.as_tensor(slots.reshape(-1, 128), device=self.device),
                torch.as_tensor(meta.reshape(-1, 128), device=self.device),
            )
        return self._star_rows

    def o2_plan(self) -> tuple[int, int]:
        """(rows per macro step, steps per epoch): slots per step ~
        batch_edges, in whole 8-row groups for every data-parallel rank
        (``trainer/come.py:1103-1110``, ``parallel/sharded.py:1561-1564``)."""
        NR = self._star_layout()[0].shape[0]
        unit = 8 * self.workers
        rps = max(unit, min(-(-self.cfg.batch_edges // 128), NR))
        rps = -(-rps // unit) * unit
        return rps, -(-NR // rps)

    def o2_step(self, slots: torch.Tensor, meta: torch.Tensor,
                pools: torch.Tensor, words: float):
        """One O2 macro step over an explicit slot stream and pools; advances
        ``words_seen`` by ``words``.  Returns (loss, n_pairs) tensors."""
        cfg = self.cfg
        ne = self.params.node_emb
        with self._update(ne):
            _, loss, npairs = star_sgns_step(
                ne, slots, meta, pools, self.lr() * cfg.alpha, self.negw,
                pool_refresh=cfg.walk_pool_refresh,
                mxu_bf16=cfg.walk_kernel_bf16,
            )
        self.words_seen += words
        return loss, npairs

    def o2_stream(self, row_perm: torch.Tensor):
        """The epoch's slot and meta rows [steps * rps, 128]: layout rows in
        ``row_perm`` order, padded with self-masking rows (meta -2) to
        whole steps."""
        rs, rm = self._star_layout()
        rps, steps = self.o2_plan()
        pad = steps * rps - rs.shape[0]
        F = torch.nn.functional
        return (F.pad(rs[row_perm], (0, 0, 0, pad)),
                F.pad(rm[row_perm], (0, 0, 0, pad), value=PAD_META))

    def o2_arc_plan(self) -> tuple[int, int]:
        """(arcs per macro step B, steps S) of the per-arc O2 epoch
        (``trainer/come.py:1136-1138``); B rounds down to whole columns of
        the data-parallel ranks (``parallel/sharded.py:1600-1603``)."""
        e, W = self.graph.num_arcs, self.workers
        B = min(self.cfg.batch_edges, e)
        B = max(W, B // W * W)
        return B, math.ceil(e / B)

    def o2_arc_step(self, src: torch.Tensor, dst: torch.Tensor):
        """One per-arc O2 macro step (``_o2_epoch``, ``trainer/come.py:
        1053-1088``): the B arcs ``src -> dst`` through the micro-batched
        tier on the tied table at ``lr * alpha``; advances ``words_seen`` by
        B.  Returns (loss, n_pairs) tensors."""
        cfg = self.cfg
        negs = None
        if cfg.negative_mode != "shared":
            negs = sample_alias(self.accept, self.alias, self.data_gen,
                                (src.shape[0], cfg.negative))
        ne = self.params.node_emb
        loss, npairs = self._sgns_microbatched(
            ne, ne, src, dst, negs, torch.ones_like(src, dtype=torch.float32),
            self.lr() * cfg.alpha, tie_tables=True,
        )
        self.words_seen += float(src.shape[0] * self.workers)
        return loss, npairs

    def o2_arc_epoch(self) -> float:
        """One pass over every directed arc, shuffled, in S batches of B;
        the tail batch wraps to the epoch's first arcs as ``jnp.resize``
        does (``trainer/come.py:1136-1144``)."""
        B, S = self.o2_arc_plan()
        e = self.graph.num_arcs
        perm = self._shuffle(e)
        idx = perm[torch.arange(S * B, device=self.device) % e]
        src = self._mine(self.arc_src[idx].view(S, B))
        dst = self._mine(self.arc_dst[idx].view(S, B))
        tot_loss = torch.zeros((), device=self.device)
        tot_pairs = torch.zeros((), device=self.device)
        for s in range(S):
            loss, npairs = self.o2_arc_step(src[s], dst[s])
            tot_loss += loss
            tot_pairs += npairs
        return self._finish_o2(tot_loss, tot_pairs)

    def _undirected_edges(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Each undirected edge once (u < v), on the device, built once."""
        if self._und_edges is None:
            self._und_edges = tuple(torch.as_tensor(a, device=self.device)
                                    for a in self.graph.edges_undirected())
        return self._und_edges

    def o2_paired_plan(self) -> tuple[int, int]:
        """(rows per macro step B_r, steps S) of the paired O2 epoch
        (``trainer/come.py:1124-1128``): 64 undirected edges per 128-slot
        row, ``edges_step = max(64, min(batch_edges // 2, E))``."""
        e2 = self._undirected_edges()[0].shape[0]
        edges_step = max(64, min(self.cfg.batch_edges // 2, e2))
        B_r = -(-edges_step // 64)
        return B_r, max(1, math.ceil(e2 / (B_r * 64)))

    def o2_paired_step(self, rows: torch.Tensor, pools: torch.Tensor):
        """One paired O2 macro step (``_o2_epoch_kernel``,
        ``trainer/come.py:1016-1043``): the walk kernel's edge mode K5 on
        ``rows`` [B_r, 128] ([u0, v0, u1, v1, ...]) at ``lr * alpha``, run
        on two copies of the tied table, which becomes
        ``new_in + new_out - old``; advances ``words_seen`` by B_r * 128.
        Returns (loss, n_pairs) tensors."""
        cfg = self.cfg
        ne = self.params.node_emb
        new_in, new_out = ne.clone(), ne.clone()
        _, _, loss, npairs = walk_sgns_step(
            new_in, new_out, rows, None, pools, self.lr() * cfg.alpha,
            self.negw, window=1, pool_refresh=cfg.walk_pool_refresh,
            mxu_bf16=cfg.walk_kernel_bf16, paired=True,
        )
        ne.copy_(new_in.add_(new_out).sub_(ne))
        self.words_seen += float(rows.numel())
        return loss, npairs

    def o2_paired_epoch(self) -> float:
        """One paired O2 epoch: the undirected edges shuffled and wrapped to
        S * B_r * 64 (``jnp.resize``), S macro steps of B_r rows, each with
        its own pools (``trainer/come.py:1116-1135``)."""
        cfg = self.cfg
        B_r, S = self.o2_paired_plan()
        uu, vv = self._undirected_edges()
        e2 = uu.shape[0]
        perm = self._shuffle(e2)
        idx = perm[torch.arange(S * B_r * 64, device=self.device) % e2]
        rows = self._mine(torch.stack([uu[idx], vv[idx]], 1).reshape(
            S, B_r, 128))
        G = -(-rows.shape[1] // NW)
        n_pools = -(-G // cfg.walk_pool_refresh)
        tot_loss = torch.zeros((), device=self.device)
        tot_pairs = torch.zeros((), device=self.device)
        for s in range(S):
            pools = sample_alias(self.accept, self.alias, self.gen,
                                 (n_pools, cfg.shared_negatives))
            loss, npairs = self.o2_paired_step(rows[s], pools)
            tot_loss += loss
            tot_pairs += npairs
        return self._finish_o2(tot_loss, tot_pairs)

    def _finish_o2(self, tot_loss, tot_pairs) -> float:
        loss, pairs = torch.stack([tot_loss, tot_pairs]).tolist()
        self.last_o2_pairs = pairs
        return loss / max(pairs, 1.0)

    def o2_epoch(self) -> float:
        """One O2 epoch: through the star kernel when ``o2_star``, the
        paired edge mode when ``o2_paired``, else per arc
        (:meth:`o2_arc_epoch`).  The star epoch (``_o2_epoch_starlike``,
        ``trainer/come.py:907-982``) passes over every edge in both
        directions: the layout rows are shuffled each epoch and trained
        step by step."""
        if self.o2_paired:
            return self.o2_paired_epoch()
        if not self.o2_star:
            return self.o2_arc_epoch()
        cfg = self.cfg
        NR = self._star_layout()[0].shape[0]
        rps, steps = self.o2_plan()
        ps, pm = (self._mine(x.view(steps, rps, 128))
                  for x in self.o2_stream(self._shuffle(NR)))
        words = float(self._star_pairs) / steps
        n_pools = -(-(ps.shape[1] * 128 // NWL) // cfg.walk_pool_refresh)
        tot_loss = torch.zeros((), device=self.device)
        tot_pairs = torch.zeros((), device=self.device)
        for s in range(steps):
            pools = sample_alias(
                self.accept, self.alias, self.gen,
                (n_pools, cfg.shared_negatives),
            )
            loss, npairs = self.o2_step(ps[s].reshape(-1), pm[s].reshape(-1),
                                        pools, words)
            tot_loss += loss
            tot_pairs += npairs
        return self._finish_o2(tot_loss, tot_pairs)

    # ----------------------------------------------------- GMM, O3 (community)

    def fit_gmm(self, resp0: torch.Tensor | None = None) -> float:
        """EM on the node table (``resp0`` [V, K]: start from these
        responsibilities instead of the k-means restarts)."""
        cfg = self.cfg
        ll = fit_communities(
            self.params, self.host_gen, n_init=cfg.gmm_n_init,
            max_iter=cfg.gmm_max_iter, reg_covar=cfg.reg_covar,
            tol=cfg.gmm_tol, resp0=resp0,
        )
        return float(ll)

    def o3_step(self) -> torch.Tensor:
        cfg = self.cfg
        p = self.params
        new_emb = community_sgd_step(
            p.node_emb, p.pi, p.centroid, p.inv_cov, cfg.beta, self.lr(),
            grad_clip=cfg.o3_grad_clip,
        )
        p.node_emb.copy_(new_emb)
        return community_loss(
            p.node_emb, p.pi, p.centroid, p.chol_cov, p.inv_cov, cfg.beta
        )

    def o3_pass(self) -> float:
        loss = torch.zeros(())
        for _ in range(self.cfg.o3_steps_per_iter):
            loss = self.o3_step()
        return float(loss)

    # ----------------------------------------------------------------- driver

    def train(
        self,
        labels: np.ndarray | None = None,
        log: Callable[[str], None] | None = None,
        checkpoint_dir: str | Path | None = None,
        scalar_log=None,
    ) -> list[dict]:
        """Full alternating optimization (reference main.py loop):
        ``pretrain_epochs`` O1 epochs, then ``outer_iters`` calls of
        :meth:`outer_iteration`.  ``checkpoint_dir``: write
        ``state_iter{N}.npz`` there after every outer iteration
        (``trainer/come.py:1245-1249``).  ``scalar_log``: optional
        ``metrics.ScalarLog`` sink, one record per outer iteration.  The
        EM's recorded loops (``losses.gmm.release_plans``) are freed when
        it returns."""
        cfg = self.cfg
        say = log or (lambda s: None)
        try:
            for e in range(cfg.pretrain_epochs):
                loss = self.o1_epoch()
                say(f"pretrain O1 epoch {e}: loss/pair {loss:.4f}")
            for it in range(cfg.outer_iters):
                rec = self.outer_iteration(it, labels)
                say(f"iter {it}: " + ", ".join(
                    f"{k}={v:.4f}" for k, v in rec.items() if k != "iter"
                ))
                if scalar_log is not None:
                    scalar_log.log(it, **rec)
                if checkpoint_dir:
                    cd = Path(checkpoint_dir)
                    cd.mkdir(parents=True, exist_ok=True)
                    self.save_checkpoint(cd / f"state_iter{it}.npz")
                self._history.append(rec)
        finally:
            gmm_release_plans()
        return self._history

    def outer_iteration(self, it: int, labels: np.ndarray | None = None
                        ) -> dict:
        """One outer iteration: GMM fit, O1 and O2 epochs, the O3 pass.
        The record holds the phase losses, per-phase wall ms (taken after a
        device synchronise), the pair counts and, with ``labels``, NMI."""
        cfg = self.cfg

        def timed(rec, name, fn):
            self._sync()
            t0 = time.perf_counter()
            out = fn()
            self._sync()
            rec[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
            return out

        rec: dict = {"iter": it}
        rec["gmm_ll"] = timed(rec, "gmm", self.fit_gmm)
        for _ in range(cfg.o1_epochs_per_iter):
            rec["o1_loss"] = timed(rec, "o1", self.o1_epoch)
        for _ in range(cfg.o2_epochs_per_iter):
            rec["o2_loss"] = timed(rec, "o2", self.o2_epoch)
        rec["o3_loss"] = timed(rec, "o3", self.o3_pass)
        rec["o1_pairs"] = self.last_o1_pairs
        rec["o2_pairs"] = self.last_o2_pairs
        if labels is not None:
            rec["nmi"] = nmi_score(labels, self.communities())
        return rec

    # ----------------------------------------------------------- persistence

    def save_checkpoint(self, path) -> None:
        """Write the parameters, ``words_seen`` and both generators' states
        (``iohelpers.persist``; the JAX package can load the file)."""
        persist.save_checkpoint(path, self.params, self.words_seen,
                                self.seed, gen=self.gen,
                                host_gen=self.host_gen)

    def load_checkpoint(self, path) -> dict:
        """Restore a checkpoint of either package: the parameters and
        ``words_seen``, and the generators where the file holds the port's
        states for this device type (a JAX checkpoint holds none, so the
        streams stay as they are).  Returns which generators were restored.
        The host corpus's feeder starts its sequence anew, as the JAX
        package's does."""
        cfg = self.cfg
        params, self.words_seen, restored = persist.load_checkpoint(
            path, self.device, gen=self.gen, host_gen=self.host_gen,
            shape=(self.graph.num_nodes, cfg.dim, cfg.num_communities))
        self.params = params
        return restored

    # ------------------------------------------------------------------ views

    def embeddings(self) -> np.ndarray:
        return self.params.node_emb.cpu().numpy()

    def communities(self) -> np.ndarray:
        """argmax responsibilities — the reference's NMI input."""
        return self.params.pi.argmax(1).cpu().numpy()
