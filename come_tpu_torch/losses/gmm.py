"""Batched full-covariance GMM EM in PyTorch.

Port of ``come_tpu/losses/gmm.py`` (the single-device fit): the E and M
steps are dense linear algebra (Cholesky log-pdf, responsibility-weighted
moments), the ``n_init`` restarts run at once as a leading batch dimension
(the JAX package's ``vmap``), and the best restart is chosen by its final
mean log-likelihood.  EM stops per restart by sklearn's tol rule, as
``_em_while_loop`` does.  Every function takes optional leading batch
dimensions on the mixture parameters; ``X`` is shared.

:func:`gmm_em_fit_sharded` is the data-axis half of the JAX package's
distributed EM (``come_tpu/losses/gmm.py:174-346``) for data-parallel
training: each rank works a chunk of the rows and every moment is summed
over the ranks.

The [..., K, N, d] temporaries of the E and M steps are built over
``ROW_CHUNK`` rows of X at a time (XLA fuses them in the JAX package; at
N = 500 000 and K = 64 one whole temporary would be 16.4 GB), so only the
order of the f32 sums over N differs from the unchunked form.

The EM loop is the JAX package's ``lax.while_loop`` as a device program:
the stop rule (``em_cond``) is a device op inside each iteration.  On a
CUDA device the single-device fit records one iteration (E-step, M-step,
masks) once per shape and runs the whole loop as one launch of a CUDA
graph whose conditional WHILE node repeats it while the rule holds
(``ops/launch_plan.py::GraphPlan``); the host reads the factors' info flags
once, after the loop.  Eagerly (the CPU, and the sharded fit, whose
all-reduces are not captured) the host reads the restarts' stop flags and
the info flags after every iteration (once, at the end, with ``tol <=
0``).  An iteration past a restart's stop changes nothing of it, so both
paths give the same bits.  Every Cholesky factor and inverse is G1
(``ops/gmm_factor.py``), which reports a non-positive pivot through a
device flag: an active restart's raises ``torch.linalg.LinAlgError`` at
the next check, a stopped restart's (whose iteration is discarded) does
not.  :func:`release_plans` frees the recorded loops (``ComETrainer.train``
calls it when it returns).
"""

from __future__ import annotations

import torch

from come_tpu_torch.ops import launch_plan
from come_tpu_torch.ops.gmm_factor import gmm_factor, gmm_inverse

_LOG_2PI = 1.8378770664093453
# rows of X per [..., K, rows, d] temporary (~1.07 GB at K = 64, d = 128)
ROW_CHUNK = 32768


def _log_prob(X, means, chol):
    """Gaussian log-pdfs: X [N,d], means [...,K,d], chol [...,K,d,d]
    -> [...,N,K]."""
    d = X.shape[-1]
    quad = []
    for Xc in X.split(ROW_CHUNK):
        diff = (Xc - means[..., :, None, :]).transpose(-1, -2)  # [...,K,d,n]
        y = torch.linalg.solve_triangular(chol, diff, upper=False)
        quad.append((y * y).sum(-2))  # [...,K,n]
    quad = torch.cat(quad, -1)  # [...,K,N]
    logdet = torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    return (-0.5 * (d * _LOG_2PI + quad) - logdet[..., None]).transpose(-1, -2)


def _e_step(X, means, chol, log_w):
    """Returns (resp [...,N,K], mean log-likelihood [...])."""
    lp = _log_prob(X, means, chol) + log_w[..., None, :]
    norm = torch.logsumexp(lp, dim=-1, keepdim=True)
    return torch.exp(lp - norm), norm.mean((-2, -1))


def _scatter(X, resp, means):
    """Sum over the rows of resp-weighted outer products of ``X - means``
    [...,K,d,d] (not yet divided by nk), ``ROW_CHUNK`` rows at a time."""
    cov = 0.0
    for Xc, rc in zip(X.split(ROW_CHUNK), resp.split(ROW_CHUNK, dim=-2)):
        diff = Xc - means[..., :, None, :]  # [...,K,n,d]
        weighted = diff * rc.transpose(-1, -2)[..., None]
        cov = cov + weighted.transpose(-1, -2) @ diff
    return cov


def _chol(cov, nk, reg_covar):
    """(lower Cholesky factors of ``cov / nk + reg_covar I``, their info
    flags): G1."""
    return gmm_factor(cov, nk, reg_covar)


def _inverse(chol):
    """Inverse covariances ``(L L^T)^-1``: G1's second entry."""
    return gmm_inverse(chol)


def _m_step(X, resp, reg_covar):
    """Responsibility-weighted moments -> (means, chol, log_weights,
    info)."""
    N = X.shape[0]
    nk = resp.sum(-2) + 10.0 * torch.finfo(X.dtype).eps  # [...,K]
    means = (resp.transpose(-1, -2) @ X) / nk[..., None]
    chol, info = _chol(_scatter(X, resp, means), nk, reg_covar)
    return means, chol, torch.log(nk / N), info


def _sqdist(X, c):
    return (X * X).sum(1, keepdim=True) - 2.0 * X @ c.T + (c * c).sum(1)[None]


def _kmeans_init(X, K, generator: torch.Generator, iters: int = 8):
    """k-means-style init: K distinct random points as centers, ``iters``
    Lloyd iterations, one-hot responsibilities.  ``generator`` is a CPU
    generator (the choice of centers is a host draw)."""
    N = X.shape[0]
    idx = torch.randperm(N, generator=generator)[:K].to(X.device)
    centers = X[idx]
    for _ in range(iters):
        onehot = torch.nn.functional.one_hot(
            _sqdist(X, centers).argmin(1), K
        ).to(X.dtype)
        counts = onehot.sum(0)
        new = (onehot.T @ X) / counts.clamp_min(1.0)[:, None]
        centers = torch.where(counts[:, None] > 0, new, centers)
    return torch.nn.functional.one_hot(_sqdist(X, centers).argmin(1),
                                       K).to(X.dtype)


def _em_state(means, chol, log_w, info) -> dict:
    """The EM loop's state after the first M-step: the parameters, the
    last two mean log-likelihoods (-inf), which restarts are active, which
    had a non-positive pivot while active, the iteration and each restart's
    iteration count."""
    batch, dev = means.shape[:-2], means.device
    ninf = torch.full(batch, -float("inf"), device=dev)
    return {"means": means, "chol": chol, "log_w": log_w,
            "prev_ll": ninf, "ll": ninf.clone(),
            "active": torch.ones(batch, dtype=torch.bool, device=dev),
            "bad": (info != 0).any(-1),
            "it": torch.zeros((), dtype=torch.int32, device=dev),
            "n_iter": torch.zeros(batch, dtype=torch.int32, device=dev)}


def _go_on(st, tol):
    """``em_cond`` per restart, on the device: ``(it < 2) | (ll - prev_ll >
    tol)`` for the active restarts; ``tol <= 0`` keeps every one."""
    if tol <= 0:
        return st["active"]
    return st["active"] & ((st["it"] < 2) | (st["ll"] - st["prev_ll"] > tol))


def _em_iteration(st, e_step, m_step, tol) -> None:
    """One EM iteration on the state ``st``, in place, with device ops only
    (it can be captured): a restart that ``em_cond`` stops keeps its
    parameters and likelihoods from here on."""
    act = _go_on(st, tol)
    resp, new_ll = e_step(st["means"], st["chol"], st["log_w"])
    *new, info = m_step(resp)
    st["bad"] |= act & (info != 0).any(-1)
    for k, n in zip(("means", "chol", "log_w"), new):
        old = st[k]
        old.copy_(torch.where(act.view(act.shape + (1,) * (n.dim()
                                                          - act.dim())),
                              n, old))
    st["prev_ll"].copy_(torch.where(act, st["ll"], st["prev_ll"]))
    st["ll"].copy_(torch.where(act, new_ll, st["ll"]))
    st["n_iter"] += act.to(torch.int32)
    st["active"].copy_(act)
    st["it"] += 1


def _em_while_loop(st, e_step, m_step, max_iter, tol, plan=None) -> dict:
    """EM until the mean log-likelihood improves by less than ``tol``
    (sklearn's rule), at most ``max_iter`` iterations, judged per restart
    (``come_tpu/losses/gmm.py::_em_while_loop``).  ``it < 2`` keeps the
    first two iterations unconditional (the likelihoods start at -inf);
    ``tol <= 0`` runs every iteration.

    Eagerly, the host reads the flags after every iteration (after the
    last only, with ``tol <= 0``): it raises ``torch.linalg.LinAlgError``
    if an active restart met a non-positive pivot, and stops once no
    restart goes on.  With ``plan`` (a :class:`launch_plan.GraphPlan`
    whose buffers ``st`` are) the loop is :func:`_em_device_loop`.
    Returns ``st``."""
    if plan is not None:
        return _em_device_loop(st, e_step, m_step, max_iter, tol, plan)
    done = 0
    while True:
        if done < max_iter:
            _em_iteration(st, e_step, m_step, tol)
            done += 1
            if tol <= 0 and done < max_iter:
                continue
        bad, more = torch.stack([st["bad"].any(),
                                 _go_on(st, tol).any()]).tolist()
        _raise_if(bad, st)
        if done >= max_iter or not more:
            return st


def _em_device_loop(st, e_step, m_step, max_iter, tol, plan) -> dict:
    """The loop as one launch on the card (``jax.lax.while_loop``): the
    plan's WHILE graph runs iterations while ``em_cond`` holds for some
    restart and ``it < max_iter`` (``st["max_iter"]``), judged on the
    device; the host reads the info flags and the iteration count once,
    after it, and the plan counts the kernels of the iterations the graph
    ran.  The plan's first use runs the first iteration eagerly on the
    caller's stream (the libraries' lazy set-up, outside a capture) and
    then records the loop on the plan's stream, which runs no kernel of
    its own: work run eagerly on a second stream left every later O1 epoch
    of the process 1-1.5% slower on an H100 (``tools/first_iter.py``'s
    o1-em reading)."""
    def one():
        _em_iteration(st, e_step, m_step, tol)

    warm = 0
    if max_iter > 0:
        if plan.slot is None:
            one()
            warm = 1
            plan.capture_while(one, lambda: _go_on(st, tol), st["it"],
                               st["max_iter"], counted=(gmm_factor,))
        plan.launch()
    bad, it = torch.stack([st["bad"].any().to(torch.int32),
                           st["it"]]).tolist()
    if max_iter > 0:
        plan.ran(it - warm)
    _raise_if(bad, st)
    return st


def _raise_if(bad, st) -> None:
    if bad:
        raise torch.linalg.LinAlgError(
            "gmm: the covariance of an active EM restart is not "
            "positive-definite (restarts "
            f"{st['bad'].nonzero().flatten().tolist()})")


def _static_state(plan, st: dict) -> dict:
    """The plan's static copy of ``st`` (made at its first use)."""
    buf = plan.bufs.get("st")
    if buf is None:
        buf = plan.bufs["st"] = {k: v.clone() for k, v in st.items()}
    else:
        for k, v in st.items():
            buf[k].copy_(v)
    return buf


def gmm_em_from_resp(X, resp0, reg_covar=1e-5, max_iter=60, tol=1e-3,
                     graph=None):
    """EM from given initial responsibilities ``resp0`` [...,N,K]: one
    M-step, the tol-rule loop, a final E-step.  Returns dict(means, chol,
    inv_cov, log_weights, resp, log_likelihood, n_iter), batched like
    ``resp0`` (``n_iter``: each restart's EM iterations).  ``graph``
    (default: on a CUDA device) runs the loop as the device's WHILE graph,
    else the host checks the flags after every iteration."""
    X = X.to(torch.float32)
    if graph is None:
        graph = X.device.type == "cuda"
    plan = None
    if graph and max_iter > 0:
        stream = (torch.cuda.current_stream(X.device).cuda_stream
                  if X.device.type == "cuda" else 0)
        plan = launch_plan.graph_plan_for(
            "gmm_em", X.device, stream, (float(reg_covar), float(tol)),
            (*resp0.shape, X.shape[1], ROW_CHUNK))
        Xs = plan.bufs.get("X")
        if Xs is None:
            Xs = plan.bufs["X"] = X.clone()
        else:
            Xs.copy_(X)
        X = Xs
    st = _em_state(*_m_step(X, resp0, reg_covar))
    if plan is not None:
        st["max_iter"] = torch.full((), max_iter, dtype=torch.int32,
                                    device=X.device)
        st = _static_state(plan, st)
    st = _em_while_loop(
        st, lambda m, c, w: _e_step(X, m, c, w),
        lambda r: _m_step(X, r, reg_covar), max_iter, tol, plan)
    means, chol, log_w = (st[k].clone() for k in ("means", "chol", "log_w"))
    resp, ll = _e_step(X, means, chol, log_w)
    return dict(
        means=means, chol=chol, inv_cov=_inverse(chol),
        log_weights=log_w, resp=resp, log_likelihood=ll,
        n_iter=st["n_iter"].clone(),
    )


def gmm_em_fit(X, num_components, generator, n_init=1, max_iter=60,
               reg_covar=1e-5, tol=1e-3, graph=None):
    """Fit a full-covariance GMM with ``n_init`` k-means restarts run as one
    batch; returns the best restart's dict (see :func:`gmm_em_from_resp`)."""
    X = X.to(torch.float32)
    resp0 = torch.stack([
        _kmeans_init(X, num_components, generator) for _ in range(n_init)
    ])
    out = gmm_em_from_resp(X, resp0, reg_covar, max_iter, tol, graph=graph)
    best = int(out["log_likelihood"].argmax())
    return {k: v[best] for k, v in out.items()}


def gmm_em_fit_sharded(X, mask, num_components, generator, group=None,
                       n_init=1, max_iter=60, reg_covar=1e-5, tol=1e-3,
                       resp0=None, model=1):
    """Distributed EM over the ranks of ``group``, a (D, ``model``) mesh
    whose rank r is (r // model, r % model) (``gmm_em_fit_sharded(axis=
    "model", data_axis="data")``, ``come_tpu/losses/gmm.py:174-346``).

    ``X`` [V, d] is this rank's model shard of the table (the whole table
    at model 1, the same on every rank), and ``mask`` [V] (None: all ones)
    weights its rows, 0 for pad rows.  Each of the D data ranks of a shard
    works the part of ``rows = ceil(V / D)`` rows from ``data_index * rows``
    (zero-weight pad rows past V); ``nk``, the means, the covariances and
    the log-likelihood are summed over the whole mesh, so every rank takes
    the same EM path and stops at the same iteration.  The k-means init
    draws K global row ids, one per stride of ``V * model // K`` rows of
    the model-shard-major id space, from the host ``generator``, which
    must be in the same state on every rank; each rank contributes the
    centers it holds.  The ``n_init`` restarts run at once as a leading
    batch dimension, as in :func:`gmm_em_fit` (the JAX package runs them
    in turn), and the best by log-likelihood wins.  ``resp0`` [V, K]
    (this shard's rows) starts EM from these responsibilities instead.
    The responsibilities returned cover every row of ``X`` (row-wise
    normalisation is local), so they are the same on every data rank of a
    shard.  The loop runs eagerly (no collective is captured) and reads
    its flags after every iteration; every rank holds the same all-reduced
    likelihoods and factors, so every rank stops at the same iteration.

    Returns the dict of :func:`gmm_em_from_resp` for the best restart."""
    from come_tpu_torch.parallel.collectives import all_reduce_, world_rank

    K = num_components
    X = X.to(torch.float32)
    V, d = X.shape
    dev = X.device
    w = (torch.ones(V, device=dev) if mask is None
         else mask.to(device=dev, dtype=torch.float32))
    world, rank = world_rank(group)
    D, (r, mi) = world // model, divmod(rank, model)
    rows = -(-V // D)  # this rank's part of the shard
    pad = rows * D - V

    def mine(a):
        return torch.nn.functional.pad(a, (0, 0) * (a.dim() - 1) + (0, pad))[
            r * rows:(r + 1) * rows]

    Xc, wc = mine(X), mine(w)
    n_total = all_reduce_(wc.sum(), group)
    eps = 10.0 * torch.finfo(torch.float32).eps

    def moments(resp):
        """All-reduced (sums of resp [n, K], of resp^T X [n, K, d])."""
        sums = all_reduce_(torch.cat([resp.sum(-2)[..., None],
                                      resp.transpose(-1, -2) @ Xc], -1),
                           group)
        return sums[..., 0], sums[..., 1:]

    def m_step(resp):
        resp = resp * wc[:, None]
        nk, sx = moments(resp)
        nk = nk + eps
        means = sx / nk[..., None]
        cov = all_reduce_(_scatter(Xc, resp, means), group)
        chol, info = _chol(cov, nk, reg_covar)
        return means, chol, torch.log(nk / n_total), info

    def e_step(means, chol, log_w):
        lp = _log_prob(Xc, means, chol) + log_w[..., None, :]
        norm = torch.logsumexp(lp, dim=-1, keepdim=True)
        ll = all_reduce_((norm[..., 0] * wc).sum(-1), group) / n_total
        return torch.exp(lp - norm), ll

    def init_resp():
        # one center per stride of rows, so the K global ids are distinct
        stride = max(V * model // K, 1)
        offs = torch.stack([torch.randint(0, stride, (K,),
                                          generator=generator)
                            for _ in range(n_init)])
        idx = torch.clamp(torch.arange(K) * stride + offs,
                          max=V * model - 1).to(dev)
        local = idx - mi * V
        ok = (local >= 0) & (local < V)
        local = local - r * rows
        ok = ok & (local >= 0) & (local < rows)
        centers = torch.where(ok[..., None],
                              Xc[local.clamp(0, rows - 1)], 0.0)
        centers = all_reduce_(centers, group)  # [n, K, d]

        def assign(c):
            d2 = ((Xc * Xc).sum(1, keepdim=True) - 2.0 * Xc @ c.transpose(
                -1, -2) + (c * c).sum(-1)[..., None, :])
            return torch.nn.functional.one_hot(d2.argmin(-1), K).to(X.dtype)

        for _ in range(8):
            counts, sx = moments(assign(centers) * wc[:, None])
            new = sx / counts.clamp_min(1.0)[..., None]
            centers = torch.where(counts[..., None] > 0, new, centers)
        return assign(centers)

    rc = init_resp() if resp0 is None else mine(resp0.to(X))[None]
    st = _em_while_loop(_em_state(*m_step(rc)), e_step, m_step, max_iter,
                        tol)
    means, chol, log_w = st["means"], st["chol"], st["log_w"]
    _, ll = e_step(means, chol, log_w)
    best = int(ll.argmax())
    means, chol, log_w = means[best], chol[best], log_w[best]
    resp, _ = _e_step(X, means, chol, log_w)
    return dict(
        means=means, chol=chol, inv_cov=_inverse(chol),
        log_weights=log_w, resp=resp, log_likelihood=ll[best],
        n_iter=st["n_iter"][best],
    )


def release_plans() -> None:
    """Free the recorded EM loops (their graphs, private memory pools and
    static buffers); the next fit of a shape records its loop again."""
    if launch_plan.plans("gmm_em"):
        from come_tpu_torch.ops import build

        launch_plan.release_plans(build.library(), entry="gmm_em")


def fit_communities(params, generator, n_init=1, max_iter=60,
                    reg_covar=1e-5, tol=1e-3, resp0=None):
    """EM on ``params.node_emb``; writes means, Cholesky factors, inverse
    covariances and responsibilities into ``params`` in place and returns
    the mean log-likelihood (0-dim tensor).  ``resp0`` [N,K] starts EM from
    given responsibilities instead of the k-means restarts."""
    X = params.node_emb
    if resp0 is None:
        out = gmm_em_fit(X, params.num_communities, generator, n_init,
                         max_iter, reg_covar, tol)
    else:
        out = gmm_em_from_resp(X, resp0.to(X), reg_covar, max_iter, tol)
    params.centroid.copy_(out["means"])
    params.chol_cov.copy_(out["chol"])
    params.inv_cov.copy_(out["inv_cov"])
    params.pi.copy_(out["resp"])
    return out["log_likelihood"]
