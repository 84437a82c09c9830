"""Process-group initialisation and the multi-process launcher.

Port of ``come_tpu/parallel/distributed.py``: one process per rank, the
group made by ``torch.distributed.init_process_group`` from torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
``MASTER_PORT``) or from explicit arguments.  The backend is NCCL for a
CUDA device and gloo for the CPU unless one is named; neither is ever
chosen in place of the other, and an init that fails raises.  Each rank's
card is ``cuda:{LOCAL_RANK}``: a rank whose local rank has no card of its
own is refused unless the caller names its device, which is how a
rehearsal puts two gloo ranks on one card (NCCL refuses two ranks on one
device).

Launch, one process per rank:

    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        -m come_tpu_torch.parallel.distributed --dataset blogcatalog

or, per host, with the address of rank 0's host given:

    python -m come_tpu_torch.parallel.distributed \\
        --coordinator 10.0.0.1:29500 --num-processes 2 --process-id $ID
"""

from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` when it names one (``cpu``,
    ``cuda:1``), else ``cuda:{LOCAL_RANK}``, refused when there is no such
    card."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return device
    local = int(os.environ.get("LOCAL_RANK", "0"))
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if local >= n:
        raise RuntimeError(
            f"local rank {local} has no card of its own ({n} visible): "
            "launch at most one rank per card, or name the device "
            "(--device cuda:0 with --backend gloo puts ranks on one card)"
        )
    return torch.device("cuda", local)


def initialize_distributed(
    backend: str | None = None,
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    device=None,
) -> torch.device:
    """Initialise the default process group and return this rank's device
    (:func:`rank_device`).  ``init_method`` None reads torchrun's
    environment (``env://``).  ``backend`` None takes NCCL for a CUDA
    device and gloo for the CPU; NCCL on the CPU is refused."""
    dev = rank_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"backend nccl needs a CUDA device, not {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {}
    if world_size is not None:
        kw = dict(world_size=int(world_size), rank=int(rank))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            **kw)
    return dev


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="sharded ComE training")
    p.add_argument("--coordinator", help="host:port of rank 0 (default: "
                   "torchrun's MASTER_ADDR:MASTER_PORT)")
    p.add_argument("--num-processes", type=int)
    p.add_argument("--process-id", type=int)
    p.add_argument("--backend", choices=["nccl", "gloo"])
    p.add_argument("--device", help="this rank's device (default "
                   "cuda:LOCAL_RANK)")
    p.add_argument("--dataset", default="blogcatalog")
    p.add_argument("--model-axis", type=int, default=1,
                   help="size of the table-sharding mesh axis")
    p.add_argument("--outer-iters", type=int)
    args = p.parse_args(argv)

    dev = initialize_distributed(
        args.backend,
        f"tcp://{args.coordinator}" if args.coordinator else None,
        args.num_processes, args.process_id, args.device,
    )
    try:
        from come_tpu_torch.config import PRESETS, ComEConfig
        from come_tpu_torch.graphs import get_dataset
        from come_tpu_torch.parallel import ShardedComETrainer, make_mesh

        ds = get_dataset(args.dataset)
        cfg = PRESETS.get(args.dataset.lower(), ComEConfig()).replace(
            num_communities=ds.num_communities
        )
        if args.outer_iters is not None:
            cfg = cfg.replace(outer_iters=args.outer_iters)
        mesh = make_mesh(model=args.model_axis)
        if mesh.rank == 0:
            print(f"{mesh.data * mesh.model} processes "
                  f"({dist.get_backend()}); mesh ({mesh.data},{mesh.model})")
        trainer = ShardedComETrainer(ds.graph, cfg, mesh, dev)
        log = print if mesh.rank == 0 else None
        trainer.train(labels=ds.single_labels, log=log)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
