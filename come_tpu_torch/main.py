"""CLI driver — port of ``come_tpu/main.py``.

Usage:
    python -m come_tpu_torch.main --dataset karate [--outer-iters 3] ...

Loads a registered dataset (karate by default, as the JAX CLI), runs the full alternating ComE
optimization on ``--device`` (default ``cuda``; there is no silent CPU
fallback) and prints per-iteration losses, per-phase ms and NMI.  As the
JAX CLI: ``--resume`` loads a checkpoint of either package before training,
``--checkpoint-dir`` writes one per outer iteration, ``--eval-f1`` prints
node-classification F1 (fitted on ``--device``), ``--save`` writes the
embeddings as word2vec text and ``--plot`` the PNGs.  ``--plot`` needs
matplotlib and checks for it before anything is trained.

``--mesh D,M`` trains over a (data, model) mesh of D x M processes, one a
rank (``parallel/sharded.py``): D data-parallel rows and, at M > 1, the
tables row-sharded over M ranks whose rows move by all-to-all.  D x M must
be the world size of the process group, which comes from torchrun's
environment, from ``--distributed ADDR:PORT,N,RANK``, or is one process
for ``--mesh 1,1`` alone.  Each rank's card is ``cuda:LOCAL_RANK`` unless
``--device`` names one; the backend is NCCL on cards and gloo on the CPU
unless ``--backend`` names one.  Only rank 0 prints (the mesh, the JAX
trainer's tier names and, per iteration, the served fractions of the row
exchange) and writes ``--save`` and ``--plot``; ``--checkpoint-dir`` gets
one file per rank.

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m come_tpu_torch.main --mesh 2,2 --dataset blogcatalog
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ComE training on PyTorch/CUDA")
    p.add_argument("--dataset", default="karate")
    p.add_argument("--device", default="cuda",
                   help="torch device for tables and kernels (cuda or cpu)")
    p.add_argument("--dim", type=int)
    p.add_argument("--num-communities", type=int)
    p.add_argument("--window", type=int)
    p.add_argument("--negative", type=int)
    p.add_argument("--walk-length", type=int)
    p.add_argument("--walks-per-node", type=int)
    p.add_argument("--restart-prob", type=float,
                   help="walk restart probability (reference alpha)")
    p.add_argument("--lr", type=float)
    p.add_argument("--alpha", type=float, help="O2 loss weight")
    p.add_argument("--beta", type=float, help="O3 loss weight")
    p.add_argument("--outer-iters", type=int)
    p.add_argument("--pretrain-epochs", type=int)
    p.add_argument("--batch-walks", type=int)
    p.add_argument("--batch-edges", type=int)
    p.add_argument("--o2-mode", choices=["auto", "star", "paired", "xla"],
                   help="O2 tier (default auto: star kernel inside its "
                        "envelope, else per arc; paired: the walk kernel's "
                        "edge mode inside the same envelope; xla forces per "
                        "arc)")
    p.add_argument("--corpus", choices=["device", "host"],
                   help="walk source (default device: the torch walker on "
                        "the card; host: the C++ walker on host threads, "
                        "fed to the card batch by batch)")
    p.add_argument("--down-sample", type=float,
                   help="word2vec frequent-node subsampling threshold "
                        "(reference `sample`; 0 = off, the default)")
    p.add_argument("--seed", type=int)
    p.add_argument("--save", help="write embeddings (word2vec text) here")
    p.add_argument("--checkpoint-dir", help="save a checkpoint per iteration")
    p.add_argument("--resume", help="checkpoint .npz to resume from")
    p.add_argument("--profile-dir",
                   help="write a torch.profiler trace (TensorBoard) here")
    p.add_argument("--plot", help="write embedding-space + graph PNGs here")
    p.add_argument("--eval-f1", action="store_true",
                   help="also run node-classification F1 at the end")
    p.add_argument("--json", action="store_true", help="JSONL record output")
    p.add_argument("--mesh", help="train on a ('data','model') mesh of "
                   "processes, e.g. --mesh 2,2 (tables row-sharded over "
                   "model)")
    p.add_argument("--distributed", nargs="?", const="env",
                   help="process group: ADDR:PORT,NUM_PROCESSES,RANK, or no "
                        "value for torchrun's environment")
    p.add_argument("--backend", choices=["nccl", "gloo"],
                   help="process-group backend (default nccl on cards, gloo "
                        "on the CPU)")
    return p


def _o1_tier(t) -> str:
    b, bf16 = ("b", ", bf16") if t.cfg.walk_kernel_bf16 else ("", "")
    if t.o1_table_dtype == torch.bfloat16:
        gen = "K4 + " if t.o1_gen else ""
        return f"walk kernel on bf16 tables ({gen}K3, SR writes)"
    if t.o1_gen:
        return f"walk kernel with in-kernel walks (K4 + K1{b}{bf16})"
    if t.o1_walk_kernel:
        return f"walk kernel (K1{b}{bf16})"
    return "micro-batched (" + (
        "K6" if t.cfg.negative_mode == "shared" else "per-pair") + ")"


def _o2_tier(t) -> str:
    b, bf16 = ("b", ", bf16") if t.cfg.walk_kernel_bf16 else ("", "")
    if t.o2_star:
        return f"star kernel (K2{b}{bf16})"
    if t.o2_paired:
        return f"paired walk kernel (K5{bf16})"
    return "per arc (" + (
        "K7" if t.cfg.negative_mode == "shared" else "per-pair") + ")"


def _mesh(args: argparse.Namespace):
    """(mesh, this rank's device) for ``--mesh``/``--distributed``: the
    process group initialised as the flags say (unless one already is),
    its world size held against the mesh."""
    import os

    import torch.distributed as dist

    from come_tpu_torch.parallel import initialize_distributed, make_mesh
    from come_tpu_torch.parallel.distributed import rank_device

    d, m = (int(x) for x in (args.mesh or "0,1").split(","))
    dist_arg = args.distributed
    if dist_arg is None and "WORLD_SIZE" in os.environ:
        dist_arg = "env"
    if dist.is_initialized():
        dev = rank_device(args.device)
    elif dist_arg == "env":
        dev = initialize_distributed(args.backend, device=args.device)
    elif dist_arg is not None:
        addr, n, rank = dist_arg.rsplit(",", 2)
        dev = initialize_distributed(args.backend, f"tcp://{addr}", int(n),
                                     int(rank), args.device)
    elif d in (0, 1) and m == 1:
        dev = rank_device(args.device)  # the one-process mesh (1, 1)
    else:
        raise SystemExit(f"--mesh {args.mesh} needs {d * m} processes: "
                         "launch with torch.distributed.run or "
                         "--distributed")
    return make_mesh(d or None, m), dev


def run(args: argparse.Namespace):
    """Build the dataset, config and trainer from parsed flags, train, and
    evaluate, save and plot as the flags ask.  Returns (trainer, history).
    With ``--mesh`` or ``--distributed``, a data-parallel trainer of this
    rank; its process group stays up for the caller (:func:`main` ends
    it)."""
    if args.plot:
        from come_tpu_torch.evaluation.plots import require_matplotlib

        require_matplotlib()
    if (args.device or "").startswith("cuda") \
            and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda but torch.cuda.is_available() is False "
            "(pass --device cpu to run the kernels' plain versions)"
        )
    mesh = None
    if args.mesh is not None or args.distributed is not None:
        mesh, device = _mesh(args)
    else:
        device = torch.device(args.device)
    rank0 = mesh is None or mesh.rank == 0
    out = print if rank0 else (lambda *a, **k: None)

    from come_tpu_torch.config import PRESETS, ComEConfig
    from come_tpu_torch.graphs import get_dataset
    from come_tpu_torch.trainer import ComETrainer

    ds = get_dataset(args.dataset)
    cfg = PRESETS.get(args.dataset.lower().replace("-synthetic", ""),
                      ComEConfig())
    cfg = cfg.replace(num_communities=ds.num_communities)
    overrides = {
        k: v for k, v in vars(args).items()
        if v is not None and k in ComEConfig.__dataclass_fields__
    }
    cfg = cfg.replace(**overrides)
    dev_name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
    out(f"dataset={ds.name}: V={ds.graph.num_nodes} E={ds.graph.num_edges} "
        f"K={cfg.num_communities} d={cfg.dim} device={dev_name}")
    t0 = time.perf_counter()
    walks = " on host walks" if cfg.corpus == "host" else ""
    if mesh is None:
        trainer = ComETrainer(ds.graph, cfg, device)
        out(f"o1 tier: {_o1_tier(trainer)}{walks}, o2 tier: "
            f"{_o2_tier(trainer)}")
    else:
        import torch.distributed as dist

        from come_tpu_torch.parallel import ShardedComETrainer

        trainer = ShardedComETrainer(ds.graph, cfg, mesh, device)
        backend = dist.get_backend() if dist.is_initialized() else "none"
        out(f"mesh=({mesh.data},{mesh.model}) backend={backend} "
            f"o1_tier={trainer.o1_tier()} ({_o1_tier(trainer)}{walks}) "
            f"o2_tier={trainer.o2_tier()} ({_o2_tier(trainer)})")
    if args.resume:
        trainer.load_checkpoint(args.resume)
        out(f"resumed from {args.resume} "
            f"(words_seen={trainer.words_seen:.0f})")
    emit = (lambda s: print(json.dumps({"log": s}))) if args.json else print
    say = emit if rank0 else None
    if say is not None and mesh is not None and mesh.model > 1:
        def say(s):  # the row exchange's served fractions, per iteration
            if s.startswith("iter "):
                s += (f", o1_served={trainer.last_o1_served:.4f}, "
                      f"o2_served={trainer.last_o2_served:.4f}")
            emit(s)
    from come_tpu_torch.metrics.profiling import trace

    try:
        with trace(args.profile_dir if rank0 else None):
            history = trainer.train(labels=ds.single_labels, log=say,
                                    checkpoint_dir=args.checkpoint_dir)
    finally:
        trainer.close()
    out(f"trained in {time.perf_counter() - t0:.1f}s")
    if device.type == "cuda":
        out(f"peak device memory: "
            f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
    if history and "nmi" in history[-1]:
        out(f"final NMI: {history[-1]['nmi']:.4f}")
    if args.save or args.plot or args.eval_f1:
        # at model > 1 a collective over the model group: every rank
        emb = trainer.embeddings()
        com = trainer.communities()
    if not rank0:
        return trainer, history
    if args.eval_f1 and ds.labels is not None:
        from come_tpu_torch.evaluation import node_classification_f1

        f1 = node_classification_f1(torch.as_tensor(emb, device=device),
                                    ds.labels)
        print(f"classification: macro-F1={f1['macro_f1']:.4f} "
              f"micro-F1={f1['micro_f1']:.4f}")
    if args.save:
        from come_tpu_torch.iohelpers import save_embedding_word2vec

        save_embedding_word2vec(args.save, emb, ds.graph.node_names)
        print(f"embeddings -> {args.save}")
    if args.plot:
        _plot(trainer, ds, Path(args.plot), emb, com)
    return trainer, history


def _plot(trainer, ds, out: Path, emb, com) -> None:
    import numpy as np

    from come_tpu_torch.evaluation.plots import graph_plot, node_space_plot_2d

    out.mkdir(parents=True, exist_ok=True)
    p = trainer.params
    chol = p.chol_cov.cpu().numpy()
    covs = np.einsum("kde,kfe->kdf", chol, chol)
    node_space_plot_2d(
        emb, com, p.centroid.cpu().numpy(), covs,
        path=out / "embedding_space.png",
        title=f"{ds.name}: embedding space + GMM",
    )
    graph_plot(ds.graph, com,
               path=out / "graph_communities.png",
               title=f"{ds.name}: detected communities")
    print(f"plots -> {out}")


def main(argv=None) -> int:
    import torch.distributed as dist

    try:
        run(build_argparser().parse_args(argv))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
