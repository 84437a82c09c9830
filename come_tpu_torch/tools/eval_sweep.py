"""Multi-dataset evaluation sweep (BASELINE.json config 4) on the card.

Port of ``scripts/eval_sweep.py`` (``_heavy_tail_dataset`` ``:30-41``,
``run_one`` ``:44-106``, ``main`` ``:109-142``): runs the full ComE loop
on each dataset and reports community NMI and node-classification
macro/micro-F1 (with ``--ratios`` also the deepwalk train-ratio sweep).

    python -m come_tpu_torch.tools.eval_sweep --datasets karate dblp \\
        [--fast] [--ratios] [--mesh D,M] [--device cpu] [--json out.json]

The configuration is resolved as ``scripts/eval_sweep.py:44-68`` does
(:func:`resolve`): the preset of the lower-cased name without
``-synthetic``, else the default ``ComEConfig``, with the dataset's
community count; ``heavy-tail-dcsbm`` (``:30-41``) on the blogcatalog
preset; ``--fast`` cuts to outer 2, pretrain 1 and at most 5 walks a node.
Two rows the JAX sweep does not have:

* ``synthetic-10m-f32``: synthetic-10m with f32 O1 tables
  (``walk_kernel_bf16_tables=False``), beside the bf16 tables (K3) that the
  preset takes;
* ``low-snr-dcsbm``: the heavy-tail graph at the lower assortativity
  :data:`LOW_SNR` chose (``tests/_jax_low_snr.py``: the first of 8, 5, 3
  at which the JAX package on the CPU reads NMI in [0.4, 0.85]), on the
  blogcatalog preset.

Each row has the JAX row's keys (dataset, nodes, edges, communities, mesh,
nmi, seconds, macro_f1, micro_f1, and ``f1_by_train_ratio`` with
``--ratios``) and four more: ``device`` (``nvidia-smi``'s name and power
limit, or ``"cpu"``), ``kernels`` (the launches of each kernel during the
run, by the names of ``PERF.md`` §6; rank 0's on a mesh), ``o1_tier`` and
``peak_mib`` (``torch.cuda.max_memory_allocated`` since the row's start,
which includes what the process already held then); and two more:
``held_mib``, that held memory (``torch.cuda.memory_allocated`` at the
row's start, so the row's own peak is ``peak_mib - held_mib``; both null
on the CPU), and ``o1_tables``, the O1 tables' dtype.

Every run is on ``cuda`` unless ``--device cpu`` is given; there is no
fallback to the CPU.  A ``--mesh D,M`` row runs the port's
``ShardedComETrainer`` in D*M processes started by ``python -m
torch.distributed.run --standalone`` of this module with ``--worker``:
NCCL with a card a rank where D*M cards exist, else gloo with every rank
on the one card (the row's ``backend`` says which; gloo stages the card's
tensors through the host, so its seconds are not the tier's speed).  Rank
0 writes the row; a rank that fails fails the sweep.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

# the kernels of the sweep's paths, by the names of PERF.md §6: each is
# the sum of the wrapper counters ("launches" by mode) listed beside it
KERNELS = {
    "K1": (("walk_sgns_step", "launches"),),
    "K1b": (("walk_sgns_step", "launches_bf16"),),
    "K3": (("walk_sgns_step", "launches_bf16_tables"),
           ("walk_sgns_gen_step", "launches_bf16_tables")),
    "K4": (("walk_sgns_gen_step", "launches"),),
    "K4+K1b": (("walk_sgns_gen_step", "launches_bf16"),),
    "K5": (("walk_sgns_step", "launches_paired"),),
    "K2": (("star_sgns_step", "launches"),),
    "K2b": (("star_sgns_step", "launches_bf16"),),
    "K6": (("fused_sgns_step", "launches"),),
    "K7": (("fused_sgns_step_tied", "launches"),),
}

# the graph of scripts/eval_sweep.py:30-41; low-snr-dcsbm lowers its
# assortativity to LOW_SNR["assortativity"]
DC_SBM = dict(num_nodes=5000, num_communities=12, avg_degree=30.0,
              exponent=2.5, seed=11)
HEAVY_TAIL_ASSORTATIVITY = 25.0
# tests/_jax_low_snr.py on the CPU: a = 8 read NMI 0.9307 (outside the
# band), a = 5 read 0.8399, so the row takes 5
LOW_SNR = {"assortativity": 5.0, "jax_cpu_nmi": 0.8398941710528017}
EXTRA = ("heavy-tail-dcsbm", "low-snr-dcsbm", "synthetic-10m-f32")


def launch_counts() -> dict[str, int]:
    """Every path kernel's launches so far, by :data:`KERNELS`' names."""
    from come_tpu_torch.ops import sgns, star_sgns, walk_sgns

    fns = {"walk_sgns_step": walk_sgns.walk_sgns_step,
           "walk_sgns_gen_step": walk_sgns.walk_sgns_gen_step,
           "star_sgns_step": star_sgns.star_sgns_step,
           "fused_sgns_step": sgns.fused_sgns_step,
           "fused_sgns_step_tied": sgns.fused_sgns_step_tied}
    return {k: sum(getattr(fns[f], a) for f, a in parts)
            for k, parts in KERNELS.items()}


def card_name() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def dc_sbm_dataset(name: str, assortativity: float):
    from come_tpu_torch.graphs import dc_sbm_graph
    from come_tpu_torch.graphs.datasets import Dataset

    kw = dict(DC_SBM)
    n, k = kw.pop("num_nodes"), kw.pop("num_communities")
    g, labels = dc_sbm_graph(n, k, assortativity=assortativity, **kw)
    return Dataset(name, g, labels, k)


def _heavy_tail_dataset():
    """dc-SBM stand-in with a power-law degree profile, the degree shape of
    the real BlogCatalog/Flickr graphs (``scripts/eval_sweep.py:30-41``)."""
    return dc_sbm_dataset("heavy-tail-dcsbm", HEAVY_TAIL_ASSORTATIVITY)


def resolve(name: str, fast: bool):
    """(dataset, config) of a sweep name, by ``scripts/eval_sweep.py:
    53-68``'s rule and this module's extra rows."""
    from come_tpu_torch.config import PRESETS, ComEConfig
    from come_tpu_torch.graphs import get_dataset

    if name == "heavy-tail-dcsbm":
        ds, cfg = _heavy_tail_dataset(), PRESETS["blogcatalog"]
    elif name == "low-snr-dcsbm":
        ds = dc_sbm_dataset(name, LOW_SNR["assortativity"])
        cfg = PRESETS["blogcatalog"]
    elif name == "synthetic-10m-f32":
        ds = get_dataset("synthetic-10m")
        cfg = PRESETS["synthetic-10m"].replace(walk_kernel_bf16_tables=False)
    else:
        ds = get_dataset(name)
        cfg = PRESETS.get(name.lower().replace("-synthetic", ""),
                          ComEConfig())
    cfg = cfg.replace(num_communities=ds.num_communities)
    if fast:
        cfg = cfg.replace(outer_iters=2, pretrain_epochs=1,
                          walks_per_node=min(cfg.walks_per_node, 5))
    return ds, cfg


def o1_tier(tr) -> str:
    """The O1 tier: the sharded trainer's JAX name, else the one-device
    trainer's walk kernel (in-kernel walks, bf16 tables) or micro-batched
    tier."""
    if hasattr(tr, "o1_tier"):
        return tr.o1_tier()
    if tr.o1_walk_kernel:
        return ("walk-kernel" + ("-gen" if tr.o1_gen else "")
                + ("-bf16-tables" if tr.o1_table_dtype == torch.bfloat16
                   else ""))
    return ("micro-batched" if tr.cfg.negative_mode == "shared"
            else "per-pair")


def run_one(name: str, fast: bool, mesh_shape: tuple[int, int] | None,
            ratios: bool = False, device=None,
            return_embeddings: bool = False):
    """Train ``name`` and return its row (with ``return_embeddings``, and
    on one device: (row, embeddings [V, d])).  With ``mesh_shape`` outside
    a process group this starts the ranks (:func:`_launch_mesh`); inside
    one (``--worker``) it is one rank's run, and only rank 0 returns the
    row."""
    import torch.distributed as dist

    if mesh_shape is not None and not dist.is_initialized():
        return _launch_mesh(name, fast, mesh_shape, ratios, device)
    from come_tpu_torch.evaluation import (
        f1_train_ratio_sweep,
        node_classification_f1,
    )

    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("eval_sweep: no CUDA card (pass --device cpu to "
                           "run on the CPU)")
    ds, cfg = resolve(name, fast)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
    before = launch_counts()
    t0 = time.time()
    if mesh_shape is not None:
        from come_tpu_torch.parallel import ShardedComETrainer, make_mesh

        tr = ShardedComETrainer(ds.graph, cfg, make_mesh(*mesh_shape), dev)
    else:
        from come_tpu_torch.trainer import ComETrainer

        tr = ComETrainer(ds.graph, cfg, dev)
    hist = tr.train(labels=ds.single_labels)
    tr._sync()
    secs = round(time.time() - t0, 1)
    emb = tr.embeddings() if ds.labels is not None else None
    if mesh_shape is not None and dist.get_rank() != 0:
        return None
    out = {
        "dataset": name if name in EXTRA else ds.name,
        "nodes": ds.graph.num_nodes,
        "edges": ds.graph.num_edges,
        "communities": cfg.num_communities,
        "mesh": list(mesh_shape) if mesh_shape else None,
        "nmi": hist[-1].get("nmi"),
        "seconds": secs,
    }
    if emb is not None:
        out.update(node_classification_f1(emb, ds.labels))
        if ratios:
            out["f1_by_train_ratio"] = {
                str(r): {k: round(v, 4) for k, v in d.items()}
                for r, d in f1_train_ratio_sweep(emb, ds.labels).items()
            }
    after = launch_counts()
    out.update({
        "device": card_name() if cuda else "cpu",
        "kernels": {k: after[k] - before[k] for k in after
                    if after[k] != before[k]},
        "o1_tier": o1_tier(tr),
        "o1_tables": str(tr.o1_table_dtype).replace("torch.", ""),
        "peak_mib": (round(torch.cuda.max_memory_allocated(dev) / 2**20, 1)
                     if cuda else None),
        "held_mib": round(held / 2**20, 1) if cuda else None,
    })
    if mesh_shape is not None:
        out["backend"] = dist.get_backend()
    if name == "low-snr-dcsbm":
        out["assortativity"] = LOW_SNR["assortativity"]
        out["jax_cpu_nmi"] = LOW_SNR["jax_cpu_nmi"]
        out["note"] = (
            "jax_cpu_nmi: the JAX package on the CPU (tests/_jax_low_snr.py)"
            ", which takes its XLA tiers there, not the Pallas walk kernel "
            "(come_tpu/trainer/come.py:248)")
    return (out, emb) if return_embeddings else out


def _launch_mesh(name, fast, mesh_shape, ratios, device) -> dict:
    """Run ``name`` on a (D, M) mesh: D*M ranks of this module under
    ``torch.distributed.run --standalone`` in a process group of their own;
    returns rank 0's row, raises if any rank fails."""
    D, M = mesh_shape
    n = D * M
    dev = torch.device(device or "cuda")
    if dev.type != "cuda":
        backend, where = "gloo", "cpu"
    elif torch.cuda.is_available() and torch.cuda.device_count() >= n:
        backend, where = "nccl", "cuda"
    elif torch.cuda.is_available():
        backend, where = "gloo", "cuda:0"
    else:
        raise RuntimeError("eval_sweep: no CUDA card (pass --device cpu to "
                           "run on the CPU)")
    root = Path(__file__).resolve().parents[2]
    with tempfile.TemporaryDirectory() as tmp:
        row = Path(tmp) / "row.json"
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(n), "-m",
               "come_tpu_torch.tools.eval_sweep", "--worker", "--datasets",
               name, "--mesh", f"{D},{M}", "--device", where, "--backend",
               backend, "--json", str(row)]
        cmd += ["--fast"] * fast + ["--ratios"] * ratios
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(root)] + os.environ.get("PYTHONPATH", "").split(os.pathsep)
        ).rstrip(os.pathsep))
        proc = subprocess.Popen(cmd, cwd=root, env=env,
                                start_new_session=True)
        try:
            rc = proc.wait()
        except BaseException:
            os.killpg(proc.pid, 9)
            proc.wait()
            raise
        if rc != 0:
            raise RuntimeError(f"eval_sweep: the {n} ranks of {name} at mesh "
                               f"{mesh_shape} exited {rc}")
        return json.loads(row.read_text())[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--datasets", nargs="+",
                   default=["karate", "dblp", "wikipedia"],
                   help="dataset names, heavy-tail-dcsbm, low-snr-dcsbm, "
                   "synthetic-10m-f32, or 'all'")
    p.add_argument("--fast", action="store_true")
    p.add_argument("--ratios", action="store_true",
                   help="include the F1 train-ratio sweep per dataset")
    p.add_argument("--json", help="write results JSON here")
    p.add_argument("--mesh", help="run through ShardedComETrainer on a "
                   "(data,model) mesh, e.g. --mesh 2,2")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    p.add_argument("--worker", action="store_true",
                   help=argparse.SUPPRESS)  # one rank of a --mesh row
    p.add_argument("--backend", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    mesh_shape = None
    if args.mesh:
        d, m = (int(x) for x in args.mesh.split(","))
        mesh_shape = (d, m)

    names = args.datasets
    if names == ["all"]:
        from come_tpu_torch.graphs.datasets import DATASETS

        names = sorted(DATASETS) + ["heavy-tail-dcsbm"]
    device = args.device
    if args.worker:
        from come_tpu_torch.parallel.distributed import (
            initialize_distributed,
        )

        device = initialize_distributed(args.backend, device=args.device)
    results = []
    try:
        for name in names:
            if not args.worker:
                print(f"=== {name} ===", flush=True)
            res = run_one(name, args.fast, mesh_shape, ratios=args.ratios,
                          device=device)
            if res is not None:
                if not args.worker:
                    print(json.dumps(res), flush=True)
                results.append(res)
    finally:
        if args.worker:
            import torch.distributed as dist

            dist.destroy_process_group()
    if args.json and results:
        Path(args.json).write_text(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
