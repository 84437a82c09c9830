"""The one-time cost of the first outer iteration, component by component.

    python come_tpu_torch/tools/first_iter.py [--root DIR] [--label NAME]
        [--runs blogcatalog synthetic-10m] [--readings] [--device cuda]
        [--outer 2] [--pretrain 2] [--trainer single|dp] [--profile]
        [--out FILE] [--cache DIR]

Each run trains one preset (pretrain 2 + outer 2 by default) through
``ComETrainer`` (``--trainer dp``: ``ShardedComETrainer``, one NCCL rank)
in a fresh Python process, so the process's first uses of cuBLAS, of the
linear-algebra libraries and of each kernel land inside it.  Every
component is timed on the host clock between device synchronises:

  * per outer iteration, through the trainer's own methods: the GMM fit,
    O1, O2 (with the star layout's build and the first O2 macro step,
    which records and instantiates the K2 plan, beside the median of the
    others), O3 and NMI;
  * every O1 epoch, pretrain included, with the K1 plans' recordings,
    instantiations and updates in it and the device memory the process
    holds after it; the trainer's construction, the wall from the
    construction to the last result, and the memory held once ``train``
    has returned;
  * with this checkout's package, the GMM fit's parts: the k-means init,
    the EM loop (its ms and iterations; its first use's recording
    apart), the factor calls made outside a graph
    (count and ms), the final E-step, the inverse covariances, and G1's
    launches.  ``--root`` runs the ``come_tpu_torch`` package of another
    checkout (run this file by its path, not with ``-m``), so two trees
    compare on one card in one call; there only the trainer's components
    are timed.

``--profile`` runs one more O1 epoch after training under
``torch.profiler`` and reports its device time by kernel.
``--readings`` adds five processes of their own: the first
``torch.linalg.cholesky`` (and ``torch.cholesky_inverse``) on a [2, 39,
128, 128] batch, with G1's first calls beside them, the first cuBLAS
matmul, and ``build_star_layout`` at BlogCatalog's and at synthetic-10m's
size (V 500 000 and 10 002 609 edges drawn uniformly from a seed); and
``o1-em``: one blogcatalog trainer's O1 epochs (and the host time inside
its K1 calls) at each stage of its process's GMM history (this checkout's
package; :func:`child_o1_em`).  Each
process prints one JSON line; this script prints them, with the card's
name and power limit, and writes them to ``--out``.  ``--device cpu``
runs the same on the CPU (karate: a rehearsal; its times are no device
numbers).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

RUNS = ("blogcatalog", "synthetic-10m")
READINGS = ("cholesky", "matmul", "stars-blogcatalog", "stars-synthetic-10m",
            "o1-em")
O1_EM_EPOCHS = 6  # O1 epochs a stage of the o1-em reading
# the synthetic-10m size of the star-layout reading
S10M_V, S10M_E = 500_000, 10_002_609


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Clock:
    """Host ms of named components between device synchronises, per outer
    iteration (``it``: -1 before the first)."""

    def __init__(self, dev):
        self.dev = dev
        self.it = -1
        self.ms: dict = {}
        self.n: dict = {}
        self.released = None  # device MiB held before and after train's
        # release of the EM's recordings

    def add(self, name, ms):
        key = (self.it, name)
        self.ms[key] = self.ms.get(key, 0.0) + ms
        self.n[key] = self.n.get(key, 0) + 1

    def count(self, name, n):
        self.n[(self.it, name)] = self.n.get((self.it, name), 0) + n

    def wrap(self, owner, attr, name, when=lambda: True):
        """Replace ``owner.attr`` by a timed call (synchronised before and
        after) while ``when()`` holds."""
        fn = getattr(owner, attr)

        def timed(*a, **kw):
            if not when():
                return fn(*a, **kw)
            _sync(self.dev)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            _sync(self.dev)
            self.add(name, (time.perf_counter() - t0) * 1e3)
            return out

        setattr(owner, attr, timed)
        return fn

    def record(self, it):
        """{name: ms} of iteration ``it``, with {name_n: calls} where a
        component ran more than once and {name: n} of the counts."""
        return ({name: round(ms, 3) for (i, name), ms in self.ms.items()
                 if i == it}
                | {f"{name}_n": n for (i, name), n in self.n.items()
                   if i == it and (i, name) in self.ms and n != 1}
                | {name: n for (i, name), n in self.n.items()
                   if i == it and (i, name) not in self.ms})


def _dataset(name, cache: Path | None):
    """The dataset, its graph saved to / loaded from ``cache`` (the
    synthetic-10m SBM takes about a minute of host time to build)."""
    from come_tpu_torch.graphs import CSRGraph, get_dataset
    from come_tpu_torch.graphs.datasets import Dataset

    f = None if cache is None else cache / f"{name}.npz"
    if f is not None and f.exists():
        z = np.load(f)
        return Dataset(name, CSRGraph(z["indptr"], z["indices"]),
                       z["labels"], int(z["k"]))
    ds = get_dataset(name)
    if f is not None:
        np.savez(f.with_suffix(".tmp.npz"), indptr=ds.graph.indptr,
                 indices=ds.graph.indices, labels=ds.single_labels,
                 k=ds.num_communities)
        os.replace(f.with_suffix(".tmp.npz"), f)
    return ds


def _own(root) -> bool:
    """Whether ``root`` is this file's checkout."""
    return Path(root).resolve() == Path(__file__).resolve().parents[2]


def _split_gmm(clock, dev) -> None:
    """Time the GMM fit's parts through this checkout's ``losses.gmm``
    (the module's note)."""
    import torch

    from come_tpu_torch.losses import gmm
    from come_tpu_torch.ops import launch_plan
    from come_tpu_torch.ops.gmm_factor import gmm_factor
    from come_tpu_torch.parallel import ShardedComETrainer
    from come_tpu_torch.trainer import ComETrainer

    in_em = [False]

    def not_capturing():
        return dev.type != "cuda" or not torch.cuda.is_current_stream_capturing()

    clock.wrap(gmm, "_kmeans_init", "kmeans")
    loop = gmm._em_while_loop

    def em_timed(*a, **kw):
        _sync(dev)
        t0 = time.perf_counter()
        in_em[0] = True
        try:
            st = loop(*a, **kw)
        finally:
            in_em[0] = False
        _sync(dev)
        clock.add("em", (time.perf_counter() - t0) * 1e3)
        clock.count("em_iters", int(st["it"]))
        clock.count("em_iters_kept", int(st["n_iter"].max()))
        return st

    gmm._em_while_loop = em_timed
    clock.wrap(gmm, "_chol", "factor", not_capturing)
    clock.wrap(gmm, "_e_step", "final_estep", lambda: not in_em[0])
    clock.wrap(gmm, "_inverse", "inverse")
    clock.wrap(launch_plan.GraphPlan, "capture_while", "em_capture")
    def counted(fit):
        def fit_counted(self, *a, **kw):
            n0 = gmm_factor.launches
            out = fit(self, *a, **kw)
            clock.count("g1_launches", gmm_factor.launches - n0)
            return out

        return fit_counted

    for cls in (ComETrainer, ShardedComETrainer):
        cls.fit_gmm = counted(cls.fit_gmm)
    if dev.type == "cuda":  # the memory the EM's recordings held
        from come_tpu_torch.trainer import come as come_mod

        release = come_mod.gmm_release_plans

        def held():
            torch.cuda.empty_cache()
            return {"allocated": round(torch.cuda.memory_allocated(dev)
                                       / 2**20, 1),
                    "reserved": round(torch.cuda.memory_reserved(dev)
                                      / 2**20, 1)}

        def release_measured():
            before = held()
            release()
            clock.released = {"before": before, "after": held()}

        come_mod.gmm_release_plans = release_measured


def _trainer(args, ds, cfg, dev):
    """The trainer of ``--trainer`` (dp: one rank over NCCL, or gloo on the
    CPU, its process group made here on a free local port)."""
    from come_tpu_torch.trainer import ComETrainer

    if args.trainer == "single":
        return ComETrainer(ds.graph, cfg, dev)
    import socket

    import torch.distributed as dist

    from come_tpu_torch.parallel import ShardedComETrainer, make_mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    return ShardedComETrainer(ds.graph, cfg, make_mesh(), dev)


def _profile_o1(trainer, dev) -> dict:
    """One more O1 epoch under ``torch.profiler``: its host ms and the
    device ms by kernel (the ten largest, and the total)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev.type == "cuda" else [])
    _sync(dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        trainer.o1_epoch()
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
    by = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0)
        if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA \
                and t > 0:
            by[ev.key] = (t / 1e3, ev.count)
    top = sorted(by.items(), key=lambda kv: -kv[1][0])[:10]
    return {"epoch_ms": round(ms, 3),
            "device_ms": round(sum(v[0] for v in by.values()), 3),
            "kernels": {k[:60]: [round(t, 3), n] for k, (t, n) in top}}


def child_run(args) -> dict:
    """One training run in this process (see the module's note)."""
    import torch

    from come_tpu_torch.config import get_config
    from come_tpu_torch.ops import launch_plan
    from come_tpu_torch.trainer import ComETrainer
    from come_tpu_torch.trainer import come as come_mod

    dev = torch.device(args.device)
    ds = _dataset(args.dataset, Path(args.cache) if args.cache else None)
    cfg = get_config(args.dataset).replace(
        num_communities=ds.num_communities, pretrain_epochs=args.pretrain,
        outer_iters=args.outer, seed=args.seed)
    labels = ds.single_labels
    clock = Clock(dev)
    if _own(args.root):
        _split_gmm(clock, dev)
    # O2: the star layout's build and each macro step
    clock.wrap(come_mod, "build_star_layout", "star_layout")
    o2_steps: dict = {}
    o2_step = ComETrainer.o2_step

    def o2_timed(self, *a, **kw):
        _sync(dev)
        t0 = time.perf_counter()
        out = o2_step(self, *a, **kw)
        _sync(dev)
        o2_steps.setdefault(clock.it, []).append(
            (time.perf_counter() - t0) * 1e3)
        return out

    ComETrainer.o2_step = o2_timed
    clock.wrap(come_mod, "nmi_score", "nmi")
    clock.wrap(ComETrainer, "communities", "nmi_argmax")
    o1_epochs: list = []
    o1_epoch = ComETrainer.o1_epoch

    def o1_timed(self):
        k1 = launch_plan.graph_counts()["walk_sgns"]
        _sync(dev)
        t0 = time.perf_counter()
        out = o1_epoch(self)
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        k1b = launch_plan.graph_counts()["walk_sgns"]
        o1_epochs.append({
            "it": clock.it, "ms": round(ms, 3),
            **{f"k1_{c}": k1b[c] - k1[c]
               for c in ("recordings", "instantiations", "updates")},
            "reserved_mib": (round(torch.cuda.memory_reserved(dev) / 2**20,
                                   1) if dev.type == "cuda" else None)})
        return out

    ComETrainer.o1_epoch = o1_timed
    outer = ComETrainer.outer_iteration

    def outer_tracked(self, it, *a, **kw):
        clock.it = it
        return outer(self, it, *a, **kw)

    ComETrainer.outer_iteration = outer_tracked

    if dev.type == "cuda":
        torch.zeros(1, device=dev)  # the context, outside every clock
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    trainer = _trainer(args, ds, cfg, dev)
    _sync(dev)
    construct_ms = (time.perf_counter() - t0) * 1e3
    hist = trainer.train(labels)
    _sync(dev)
    wall = time.perf_counter() - t0
    iters = []
    for rec in hist:
        it = rec["iter"]
        steps = o2_steps.get(it, [])
        parts = clock.record(it)
        iters.append({
            "iter": it,
            "s": sum(rec[f"{k}_ms"] for k in ("gmm", "o1", "o2", "o3")) / 1e3,
            **{f"{k}_ms": round(rec[f"{k}_ms"], 3)
               for k in ("gmm", "o1", "o2", "o3")},
            "gmm_parts": {k: v for k, v in parts.items()
                          if not k.startswith(("star_layout", "nmi"))},
            "star_layout_ms": parts.get("star_layout"),
            "o2_first_step_ms": round(steps[0], 3) if steps else None,
            "o2_other_steps_ms": (round(statistics.median(steps[1:]), 3)
                                  if len(steps) > 1 else None),
            "o2_steps": len(steps),
            "nmi_ms": round(parts.get("nmi", 0.0)
                            + parts.get("nmi_argmax", 0.0), 3),
            "nmi": rec.get("nmi"),
        })
    out = {
        "run": args.dataset, "label": args.label, "device": str(dev),
        "trainer": args.trainer,
        "pretrain": cfg.pretrain_epochs, "outer": cfg.outer_iters,
        "construct_ms": round(construct_ms, 3),
        "pretrain_o1_ms": [e["ms"] for e in o1_epochs[:cfg.pretrain_epochs]],
        "o1_epochs": list(o1_epochs), "iters": iters, "wall_s": round(wall, 4),
    }
    if dev.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        torch.cuda.empty_cache()
        out["em_release_mib"] = clock.released
        out["held_after_train_mib"] = {
            "allocated": round(torch.cuda.memory_allocated(dev) / 2**20, 1),
            "reserved": round(torch.cuda.memory_reserved(dev) / 2**20, 1)}
    if args.profile:
        out["profile_o1"] = _profile_o1(trainer, dev)
    if args.trainer == "dp":
        import torch.distributed as dist

        dist.destroy_process_group()
    return out


def child_cholesky(args) -> dict:
    """The process's first torch.linalg.cholesky and cholesky_inverse on a
    [2, 39, 128, 128] batch, then a second call of each; with this
    checkout's package, then G1's first and second calls."""
    import torch

    dev = torch.device(args.device)
    rng = np.random.default_rng(0)
    A = rng.normal(size=(2, 39, 128, 256)).astype(np.float32)
    spd = np.einsum("bkij,bklj->bkil", A, A) / 256 + 1e-5 * np.eye(128)
    x = torch.as_tensor(spd.astype(np.float32)).to(dev)
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
    _sync(dev)
    out = {"reading": "cholesky", "label": args.label, "shape": list(x.shape)}

    def timed(fn):
        _sync(dev)
        t0 = time.perf_counter()
        r = fn()
        _sync(dev)
        return r, round((time.perf_counter() - t0) * 1e3, 3)

    L, out["cholesky_first_ms"] = timed(lambda: torch.linalg.cholesky(x))
    _, out["cholesky_second_ms"] = timed(lambda: torch.linalg.cholesky(x))
    _, out["cholesky_inverse_first_ms"] = timed(
        lambda: torch.cholesky_inverse(L))
    _, out["cholesky_inverse_second_ms"] = timed(
        lambda: torch.cholesky_inverse(L))
    if not _own(args.root):
        return out
    from come_tpu_torch.ops import build
    from come_tpu_torch.ops.gmm_factor import gmm_factor, gmm_inverse

    if dev.type == "cuda":
        _, out["kernels_build_s"] = timed(lambda: build.library())
    cov, nk = x * 7.0, torch.full(x.shape[:2], 7.0, device=dev)
    (G, _), out["g1_factor_first_ms"] = timed(
        lambda: gmm_factor(cov, nk, 0.0))
    _, out["g1_factor_second_ms"] = timed(lambda: gmm_factor(cov, nk, 0.0))
    _, out["g1_inverse_first_ms"] = timed(lambda: gmm_inverse(G))
    _, out["g1_inverse_second_ms"] = timed(lambda: gmm_inverse(G))
    return out


def child_o1_em(args) -> dict:
    """O1 epochs of one blogcatalog trainer, in stages of this process's
    GMM history (this checkout's package): before any fit, after a fit with
    the eager loop, after a WHILE graph of one trivial op, after a fit with
    the device program, after an eager fit on a stream of its own, and
    after the graphs are freed (and the cache emptied).  Per epoch: its host ms
    and the host ms spent inside the K1 wrapper's calls."""
    import torch

    from come_tpu_torch.config import get_config
    from come_tpu_torch.losses import gmm
    from come_tpu_torch.ops import build, launch_plan
    from come_tpu_torch.trainer import ComETrainer
    from come_tpu_torch.trainer import come as come_mod

    dev = torch.device(args.device)
    name = args.dataset or "blogcatalog"
    ds = _dataset(name, Path(args.cache) if args.cache else None)
    cfg = get_config(name).replace(num_communities=ds.num_communities,
                                   seed=args.seed)
    trainer = ComETrainer(ds.graph, cfg, dev)
    inside = [0.0]
    k1 = come_mod.walk_sgns_step

    def k1_timed(*a, **kw):
        t0 = time.perf_counter()
        out = k1(*a, **kw)
        inside[0] += (time.perf_counter() - t0) * 1e3
        return out

    come_mod.walk_sgns_step = k1_timed

    def epochs():
        rows = []
        for _ in range(O1_EM_EPOCHS):
            inside[0] = 0.0
            _sync(dev)
            t0 = time.perf_counter()
            trainer.o1_epoch()
            _sync(dev)
            rows.append([round((time.perf_counter() - t0) * 1e3, 3),
                         round(inside[0], 3)])
        return rows

    def fit(graph):
        gmm.gmm_em_fit(trainer.params.node_emb, ds.num_communities,
                       torch.Generator().manual_seed(args.seed),
                       cfg.gmm_n_init, cfg.gmm_max_iter, cfg.reg_covar,
                       cfg.gmm_tol, graph=graph)

    def trivial_while():
        stream = torch.cuda.current_stream(dev).cuda_stream
        plan = launch_plan.graph_plan_for("while_probe", dev, stream, (),
                                          (1,))
        it = torch.zeros((), dtype=torch.int32, device=dev)
        top = torch.full((), 3, dtype=torch.int32, device=dev)
        go = torch.ones((1,), dtype=torch.bool, device=dev)
        plan.capture_while(lambda: it.add_(1), lambda: go, it, top)
        plan.launch()
        if int(it) != 3:
            raise AssertionError(f"while probe ran {int(it)} of 3")

    trainer.o1_epoch()  # the kernels' and the plan's first use
    out = {"reading": "o1-em", "label": args.label,
           "columns": ["epoch_ms", "k1_host_ms"], "none": epochs()}
    fit(False)
    out["eager_fit"] = epochs()
    if dev.type == "cuda":
        trivial_while()
        out["while_graph"] = epochs()
        fit(True)
        out["device_fit"] = epochs()
        side = torch.cuda.Stream(dev)  # an eager fit on a stream of its own
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fit(False)
        torch.cuda.current_stream(dev).wait_stream(side)
        out["side_stream_fit"] = epochs()
        gmm.release_plans()
        launch_plan.release_plans(build.library(), entry="while_probe")
        torch.cuda.empty_cache()
        out["released"] = epochs()
    return out


def child_matmul(args) -> dict:
    """The process's first cuBLAS matmul ([10312, 128] @ [128, 39]), then a
    second."""
    import torch

    dev = torch.device(args.device)
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.normal(size=(10312, 128)).astype(np.float32)).to(dev)
    b = torch.as_tensor(rng.normal(size=(128, 39)).astype(np.float32)).to(dev)
    out = {"reading": "matmul", "label": args.label}
    for k in ("first", "second"):
        _sync(dev)
        t0 = time.perf_counter()
        a @ b
        _sync(dev)
        out[f"{k}_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
    return out


def child_stars(args, which: str) -> dict:
    """build_star_layout at BlogCatalog's or synthetic-10m's size (with
    this checkout's package, the C++ library's build timed apart)."""
    from come_tpu_torch.sampling import stars

    if which == "blogcatalog":
        u, v = _dataset("blogcatalog", None).graph.edges_undirected()
        V = int(max(u.max(), v.max())) + 1
    else:
        rng = np.random.default_rng(0)
        V = S10M_V
        u = rng.integers(0, V, S10M_E, dtype=np.int64)
        v = (u + rng.integers(1, V, S10M_E, dtype=np.int64)) % V
    out = {"reading": f"stars-{which}", "label": args.label, "V": V,
           "E": int(u.shape[0])}
    if _own(args.root):
        from come_tpu_torch.native import build as nbuild

        t0 = time.perf_counter()
        nbuild.load_stars()
        out["cpp_build_s"] = round(time.perf_counter() - t0, 4)
    t0 = time.perf_counter()
    s, _ = stars.build_star_layout(u, v, V)
    out["build_star_layout_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
    out["slots"] = int(s.shape[0])
    return out


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return "no nvidia-smi"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                   help="checkout whose come_tpu_torch to run")
    p.add_argument("--label", default="tree")
    p.add_argument("--runs", nargs="*", default=list(RUNS),
                   help=f"datasets to train ({', '.join(RUNS)}, karate)")
    p.add_argument("--readings", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--pretrain", type=int, default=2)
    p.add_argument("--outer", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trainer", choices=("single", "dp"), default="single")
    p.add_argument("--profile", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--timeout", type=float, default=900.0)
    p.add_argument("--cache", default=None,
                   help="directory that keeps the graphs between calls "
                        "(default: a temporary one per call)")
    p.add_argument("--child", default=None, help=argparse.SUPPRESS)
    p.add_argument("--dataset", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        sys.path.insert(0, str(Path(args.root).resolve()))
        if args.child == "run":
            rec = child_run(args)
        elif args.child == "cholesky":
            rec = child_cholesky(args)
        elif args.child == "matmul":
            rec = child_matmul(args)
        elif args.child == "o1-em":
            rec = child_o1_em(args)
        else:
            rec = child_stars(args, args.child.removeprefix("stars-"))
        print(json.dumps(rec), flush=True)
        return 0

    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("first_iter: needs a CUDA card (or --device cpu)")
    card = _card() if args.device.startswith("cuda") else "cpu"
    jobs = [("run", name) for name in args.runs]
    if args.readings:
        jobs += [(r, None) for r in READINGS]
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        cache = args.cache or tmp
        Path(cache).mkdir(parents=True, exist_ok=True)
        for child, name in jobs:
            if child in ("cholesky", "matmul") and args.device == "cpu":
                continue
            if child == "o1-em" and not _own(args.root):
                continue
            cmd = [sys.executable, str(Path(__file__).resolve()), "--child",
                   child, "--root", args.root, "--label", args.label,
                   "--device", args.device, "--pretrain", str(args.pretrain),
                   "--outer", str(args.outer), "--seed", str(args.seed),
                   "--cache", cache, "--trainer", args.trainer]
            if args.profile:
                cmd.append("--profile")
            if name:
                cmd += ["--dataset", name]
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=args.timeout)
            if res.returncode != 0:
                raise RuntimeError(f"first_iter {child} {name or ''} failed "
                                   f"({res.returncode}):\n{res.stderr[-4000:]}")
            rec = json.loads(res.stdout.strip().splitlines()[-1])
            rec["card"] = card
            lines.append(rec)
            print(json.dumps(rec), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in lines))
    return 0

if __name__ == "__main__":
    raise SystemExit(main())
