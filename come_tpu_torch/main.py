"""CLI driver — port of ``come_tpu/main.py``.

Usage:
    python -m come_tpu_torch.main --dataset karate [--outer-iters 3] ...

Loads a registered dataset (karate by default, as the JAX CLI), runs the full alternating ComE
optimization on ``--device`` (default ``cuda``; there is no silent CPU
fallback) and prints per-iteration losses, per-phase ms and NMI.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

# flags of come_tpu/main.py whose features are not ported yet
_NOT_YET = {
    "save": "Persistence",
    "checkpoint_dir": "Persistence",
    "resume": "Persistence",
    "plot": "Plots",
    "eval_f1": "Node-classification F1",
}


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
    p.add_argument("--down-sample", type=float,
                   help="word2vec frequent-node subsampling threshold "
                        "(reference `sample`; 0 = off, the default)")
    p.add_argument("--seed", type=int)
    p.add_argument("--save", help="write embeddings (word2vec text) here")
    p.add_argument("--checkpoint-dir", help="save a checkpoint per iteration")
    p.add_argument("--resume", help="checkpoint .npz to resume from")
    p.add_argument("--plot", help="write embedding-space + graph PNGs here")
    p.add_argument("--eval-f1", action="store_true",
                   help="also run node-classification F1 at the end")
    p.add_argument("--json", action="store_true", help="JSONL record output")
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


def run(args: argparse.Namespace):
    """Build the dataset, config and trainer from parsed flags and train.
    Returns (trainer, history)."""
    for flag, item in _NOT_YET.items():
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported yet "
                f"(ROADMAP Queue 1, '{item}')"
            )
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda but torch.cuda.is_available() is False "
            "(pass --device cpu to run the kernels' plain versions)"
        )

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
    print(f"dataset={ds.name}: V={ds.graph.num_nodes} E={ds.graph.num_edges} "
          f"K={cfg.num_communities} d={cfg.dim} device={dev_name}")
    t0 = time.perf_counter()
    trainer = ComETrainer(ds.graph, cfg, device)
    print(f"o1 tier: {_o1_tier(trainer)}, o2 tier: {_o2_tier(trainer)}")
    emit = (lambda s: print(json.dumps({"log": s}))) if args.json else print
    history = trainer.train(labels=ds.single_labels, log=emit)
    print(f"trained in {time.perf_counter() - t0:.1f}s")
    if device.type == "cuda":
        print(f"peak device memory: "
              f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
    if history and "nmi" in history[-1]:
        print(f"final NMI: {history[-1]['nmi']:.4f}")
    return trainer, history


def main(argv=None) -> int:
    run(build_argparser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
