"""Numpy gradient oracle for O1/O2/O3 — the parity harness's ground truth.

A verbatim copy of ``come_tpu/evaluation/oracle.py`` (numpy only; the port
keeps its own copy because it imports nothing of the JAX package).  Its
docstrings name the JAX package's modules, which the port's keep: the walk
and star kernels are ``ops/walk_sgns.py`` and ``ops/star_sgns.py`` here.

BASELINE.json:5 defines acceptance as "allclose on O1/O2/O3 gradients per
iteration".  The reference's hogwild trainer applies pair updates
sequentially and racily, so its trajectory is nondeterministic (SURVEY.md §7
hard part 1); the well-defined parity target is the *expected* (race-free)
gradient of a fixed batch computed from the same initial tables.  This
module computes that in plain numpy loops — deliberately scalar, mirroring
the reference's per-pair Cython arithmetic (``utils/training_sdg_inner.pyx``
[R]) — and the jnp/Pallas paths must match it to float tolerance.

Semantic note (documented divergence, SURVEY.md §7): the hogwild kernel
applies each pair's update before scoring the next pair; synchronous
minibatch SGD scores every pair against the *initial* tables and sums
duplicate-row updates.  Both are SGD on the same objective; LR scaling is
matched per pair.  The oracle implements the synchronous semantics.
"""

from __future__ import annotations

import numpy as np


def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def sgns_batch_grads(
    emb_in: np.ndarray,
    emb_out: np.ndarray,
    centers: np.ndarray,
    contexts: np.ndarray,
    negatives: np.ndarray,
    mask: np.ndarray,
    max_exp: float | None = None,
):
    """Dense-table gradients dL/demb_in, dL/demb_out for one SGNS batch.

    Pure per-pair loops; returns full [V, d] gradient tables plus the loss.
    """
    d_in = np.zeros_like(emb_in)
    d_out = np.zeros_like(emb_out)
    loss = 0.0
    P = len(centers)
    K = negatives.shape[1]
    for p in range(P):
        if not mask[p]:
            continue
        i, j = int(centers[p]), int(contexts[p])
        phi = emb_in[i]
        # positive pair
        s = float(phi @ emb_out[j])
        if max_exp is None or abs(s) < max_exp:
            g = sigmoid(s) - 1.0  # dL/ds
            loss += -np.log(max(sigmoid(s), 1e-30))
            d_in[i] += g * emb_out[j]
            d_out[j] += g * phi
        # negatives
        for k in range(K):
            n = int(negatives[p, k])
            s = float(phi @ emb_out[n])
            if max_exp is not None and abs(s) >= max_exp:
                continue
            g = sigmoid(s)  # dL/ds for label 0
            loss += -np.log(max(1.0 - sigmoid(s), 1e-30))
            d_in[i] += g * emb_out[n]
            d_out[n] += g * phi
    return loss, d_in, d_out


def sgns_batch_grads_tied(
    emb: np.ndarray, centers, contexts, negatives, mask, max_exp=None
):
    """O2 mode: both sides in one table; gradients summed into one [V,d]."""
    loss, d_in, d_out = sgns_batch_grads(
        emb, emb, centers, contexts, negatives, mask, max_exp
    )
    return loss, d_in + d_out


def sgns_shared_pool_grads(
    emb_in: np.ndarray,
    emb_out: np.ndarray,
    centers: np.ndarray,
    contexts: np.ndarray,
    pool: np.ndarray,
    mask: np.ndarray,
    negative_weight: float,
):
    """Oracle for the SHARED-NEGATIVE-POOL fast path (losses/sgns_block.py,
    ops/pallas_sgns.py): every valid pair scores all KP pool rows with
    weight ``negative_weight`` (= k / KP, keeping per-pair noise work
    calibrated to the reference's k per-pair draws,
    ``utils/training_sdg_inner.pyx`` [R]).

    Per-pair scalar loops; returns (loss, d_in [V,d], d_out [V,d]).
    """
    d_in = np.zeros_like(emb_in)
    d_out = np.zeros_like(emb_out)
    loss = 0.0
    for p in range(len(centers)):
        if not mask[p]:
            continue
        i, j = int(centers[p]), int(contexts[p])
        phi = emb_in[i]
        s = float(phi @ emb_out[j])
        g = sigmoid(s) - 1.0
        loss += -np.log(max(sigmoid(s), 1e-30))
        d_in[i] += g * emb_out[j]
        d_out[j] += g * phi
        for n in pool:
            n = int(n)
            s = float(phi @ emb_out[n])
            g = sigmoid(s) * negative_weight
            loss += -negative_weight * np.log(max(1.0 - sigmoid(s), 1e-30))
            d_in[i] += g * emb_out[n]
            d_out[n] += g * phi
    return loss, d_in, d_out


def walk_banded_shared_pool_grads(
    emb_in: np.ndarray,
    emb_out: np.ndarray,
    walks: np.ndarray,
    pool: np.ndarray,
    wrow: np.ndarray,
    negative_weight: float,
):
    """Oracle for ONE synchronous block of the walk-banded fast path
    (ops/pallas_walk_sgns.py, losses/sgns_banded.py): every in-window
    in-walk context of every center is a positive pair (center t trains
    contexts u with 0 < |u-t| <= wrow[t], the reference's reduced-window
    enumeration), and each center with ``n_t`` trained pairs scores all KP
    shared pool rows with weight ``negative_weight * n_t``.

    All gradients are with respect to the tables AS OF block start (the
    kernels' group-synchronous semantics); multi-block steps apply blocks
    sequentially — compose by calling per block.

    Args:
      walks: int [B, L] node ids.  wrow: int [B, L] per-center window draws.
    Returns (loss, n_pairs, d_in [V,d], d_out [V,d]).
    """
    d_in = np.zeros_like(emb_in)
    d_out = np.zeros_like(emb_out)
    loss = 0.0
    npairs = 0
    B, L = walks.shape
    for b in range(B):
        for t in range(L):
            i = int(walks[b, t])
            w = int(wrow[b, t])
            phi = emb_in[i]
            n_t = 0
            for u in range(max(0, t - w), min(L, t + w + 1)):
                if u == t:
                    continue
                j = int(walks[b, u])
                s = float(phi @ emb_out[j])
                g = sigmoid(s) - 1.0
                loss += -np.log(max(sigmoid(s), 1e-30))
                d_in[i] += g * emb_out[j]
                d_out[j] += g * phi
                n_t += 1
            npairs += n_t
            for n in pool:
                n = int(n)
                s = float(phi @ emb_out[n])
                g = sigmoid(s) * negative_weight * n_t
                loss += (
                    -negative_weight * n_t
                    * np.log(max(1.0 - sigmoid(s), 1e-30))
                )
                d_in[i] += g * emb_out[n]
                d_out[n] += g * phi
    return loss, npairs, d_in, d_out


def walk_banded_kernel_sequential(
    emb_in: np.ndarray,
    emb_out: np.ndarray,
    walks: np.ndarray,
    pools: np.ndarray,
    wrow: np.ndarray,
    negative_weight: float,
    lr: float,
    walks_per_group: int,
    pool_refresh: int = 1,
    paired: bool = False,
):
    """Oracle for a MULTI-GROUP fused-kernel step (ops/pallas_walk_sgns.py):
    the exact sequential composition the kernel executes, built from the
    single-block semantics of :func:`walk_banded_shared_pool_grads` (which
    documents "multi-block steps apply blocks sequentially — compose by
    calling per block").

    Per R-group block (R = ``pool_refresh``):
      * the negative pool's rows are STAGED once at block start (groups
        score negatives against these rows even after later groups update
        the tables);
      * each group of ``walks_per_group`` walks computes its banded
        positive gradients and its pool gradient against the CURRENT
        tables (walk rows) / STAGED pool rows, then applies its walk-row
        updates synchronously (duplicates sum);
      * the pool gradient accumulates across the block and is applied
        once at the block boundary (read-modify-write, so walk updates to
        pool rows within the block are preserved).

    Args:
      walks: int [B, L] with B a multiple of walks_per_group.
      pools: int [n_blocks, KP] (one pool per R-group block).
      wrow:  int [B, L] per-center window draws.
      paired: O2 edge mode — slots 2i/2i+1 are one edge and each slot's
        only context is its partner (wrow ignored).
    Returns (emb_in', emb_out', loss, n_pairs).
    """
    ei = emb_in.astype(np.float32).copy()
    eo = emb_out.astype(np.float32).copy()
    B, L = walks.shape
    nw = walks_per_group
    G = B // nw
    R = pool_refresh
    loss = 0.0
    npairs = 0
    for g in range(G):
        blk = g // R
        if g % R == 0:
            pool = pools[blk].astype(np.int64)
            staged = eo[pool].copy()  # pool rows as of block start
            dneg = np.zeros_like(staged)
        w = walks[g * nw:(g + 1) * nw]
        wr = wrow[g * nw:(g + 1) * nw]
        d_in = np.zeros_like(ei)
        d_out = np.zeros_like(eo)
        for b in range(nw):
            for t in range(L):
                i = int(w[b, t])
                ww = int(wr[b, t])
                phi = ei[i]
                n_t = 0
                ctxs = (
                    [t ^ 1]
                    if paired
                    else range(max(0, t - ww), min(L, t + ww + 1))
                )
                for u in ctxs:
                    if u == t:
                        continue
                    j = int(w[b, u])
                    s = float(phi @ eo[j])
                    gr = sigmoid(s) - 1.0
                    loss += -np.log(max(sigmoid(s), 1e-30))
                    d_in[i] += gr * eo[j]
                    d_out[j] += gr * phi
                    n_t += 1
                npairs += n_t
                # negatives vs the STAGED pool rows; gradient deferred
                for k in range(len(pool)):
                    s = float(phi @ staged[k])
                    gr = sigmoid(s) * negative_weight * n_t
                    loss += (
                        -negative_weight * n_t
                        * np.log(max(1.0 - sigmoid(s), 1e-30))
                    )
                    d_in[i] += gr * staged[k]
                    dneg[k] += gr * phi
        ei -= lr * d_in
        eo -= lr * d_out
        if g % R == R - 1 or g == G - 1:
            # block boundary: apply the accumulated pool gradient (RMW)
            for k in range(len(pool)):
                eo[pool[k]] -= lr * dneg[k]
    return ei, eo, loss, npairs


def community_grads(
    node_emb: np.ndarray,
    pi: np.ndarray,
    centroid: np.ndarray,
    inv_cov: np.ndarray,
    beta: float,
):
    """O3 gradient per node: beta/K * sum_k pi_ik Sigma_k^-1 (phi_i - psi_k).

    Mirrors the reference's chunked numpy loop (SURVEY.md §3.4 hot loop #4).
    """
    N, d = node_emb.shape
    K = centroid.shape[0]
    g = np.zeros_like(node_emb)
    for i in range(N):
        acc = np.zeros(d)
        for k in range(K):
            acc += pi[i, k] * inv_cov[k] @ (node_emb[i] - centroid[k])
        g[i] = (beta / K) * acc
    return g


def gmm_log_likelihood(X, means, covs, weights):
    """Mean per-sample GMM log-likelihood (for EM quality comparison)."""
    from scipy.stats import multivariate_normal

    N, K = X.shape[0], means.shape[0]
    lp = np.zeros((N, K))
    for k in range(K):
        lp[:, k] = multivariate_normal.logpdf(X, means[k], covs[k]) + np.log(
            weights[k]
        )
    m = lp.max(axis=1)
    return float(np.mean(m + np.log(np.exp(lp - m[:, None]).sum(axis=1))))


def star_kernel_sequential(
    emb: np.ndarray,
    slots: np.ndarray,
    meta: np.ndarray,
    pools: np.ndarray,
    negative_weight: float,
    lr: float,
    pool_refresh: int = 1,
    group_slots: int = 1024,
    block: int = 128,
) -> tuple[np.ndarray, float, float]:
    """Numpy oracle of the star O2 kernel's group semantics
    (``ops/pallas_star_sgns.py``): groups of ``group_slots`` slots run
    sequentially; each group's gradients are computed from the TIED
    table state at group start and applied by sequential per-slot RMW;
    the shared pool is staged once per ``pool_refresh``-group block and
    its accumulated gradient applies at the block end.  The mask pairs
    hub<->neighbor slots of each row-local segment (``sampling/stars.py``
    metadata encoding; pads self-mask).

    Returns (emb', total_loss, total_pairs).
    """
    emb = emb.astype(np.float32).copy()
    slots = np.asarray(slots, np.int64).reshape(-1)
    meta = np.asarray(meta, np.int64).reshape(-1)
    G = slots.shape[0] // group_slots
    pools = np.asarray(pools, np.int64)
    if pools.ndim == 1:
        pools = np.broadcast_to(
            pools, (-(-G // pool_refresh),) + pools.shape
        )
    total_loss = 0.0
    total_pairs = 0.0
    dneg_acc = None
    for g in range(G):
        if g % pool_refresh == 0:
            pool = pools[g // pool_refresh]
            cneg0 = emb[pool].copy()
            dneg_acc = np.zeros_like(cneg0)
        sl = slots[g * group_slots : (g + 1) * group_slots]
        mt = meta[g * group_slots : (g + 1) * group_slots]
        phi = emb[sl].copy()
        seg = mt >> 1
        hub = mt & 1
        blk = np.arange(group_slots) // block
        m = (
            (seg[:, None] == seg[None, :])
            & ((hub[:, None] ^ hub[None, :]) == 1)
            & (blk[:, None] == blk[None, :])
        ).astype(np.float32)
        s = phi @ phi.T
        sg = 1.0 / (1.0 + np.exp(-s))
        gpos = (sg - 1.0) * m
        total_loss += -np.sum(m * np.log(np.maximum(sg, 1e-30)))
        n_t = m.sum(1, keepdims=True)
        total_pairs += float(n_t.sum())
        dphi = gpos @ phi + gpos.T @ phi  # tied: source + context side
        sn = phi @ cneg0.T
        sgn = 1.0 / (1.0 + np.exp(-sn))
        gneg = sgn * (negative_weight * n_t)
        total_loss += -negative_weight * np.sum(
            n_t * np.log(np.maximum(1.0 - sgn, 1e-30))
        )
        dphi += gneg @ cneg0
        dneg_acc += gneg.T @ phi
        for t in range(group_slots):  # sequential RMW, kernel order
            emb[sl[t]] -= lr * dphi[t]
        if g % pool_refresh == pool_refresh - 1 or g == G - 1:
            np.add.at(emb, pool, -lr * dneg_acc)
    return emb, total_loss, total_pairs
