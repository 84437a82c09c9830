"""Persistence: word2vec-text embeddings and training checkpoints.

Port of the single-device part of ``come_tpu/iohelpers/persist.py``
(``save/load_embedding_word2vec``, ``save/load_checkpoint``).  The
word2vec text is the JAX writer's byte for byte.  A checkpoint is one
``.npz``, written to a temporary file and renamed so an interrupted save
cannot corrupt the previous one, under the JAX package's keys:

* ``node_emb``, ``ctx_emb``, ``centroid``, ``chol_cov``, ``inv_cov``,
  ``pi`` (float32) and ``words_seen`` (float64 here; the JAX package reads
  it as float32);
* ``key``: a uint32[2] threefry key made from the seed, the form
  ``jax.random.key(seed)`` takes.  It is there so that the JAX package's
  ``load_checkpoint``, which reads ``key`` unconditionally, can load the
  file; it is not the port's random stream, which threefry cannot express.

The port's own streams go under keys of their own: ``torch_gen_state`` and
``torch_gen_device`` (the device generator's state and device type) and
``torch_host_gen_state`` (the host generator's).  The two packages' streams
cannot map onto each other, so a cross-load restores the parameters and
``words_seen`` and leaves the loader's stream as it was, as the JAX package
does with a checkpoint that has no ``host_key``.

Sharded training writes the JAX package's sharded form
(``save_checkpoint_sharded``, ``come_tpu/iohelpers/persist.py:123-240``):
one file per process, ``<path>.proc<i>.npz``, holding
``_process_count``, the topology as ``_meta.data``, ``_meta.model``,
``_meta.v_real`` and ``_meta.interleave``, every leaf with its
``<name>.shape``, plus that rank's generator states under the port's
keys.  At model 1 every leaf is whole (each process holds the whole
replica, as the JAX writer stores a fully addressable leaf); at model > 1
the row leaves (``node_emb``, ``ctx_emb``, ``pi``) are this process's
block ``<name>@<row_start>`` of the padded, interleaved [V_pad, ...]
table.  :func:`load_checkpoint_global` merges the files of either package
(whole leaves, or ``<name>@<row>`` blocks) and :func:`load_logical` puts
the rows back in node order (the interleave undone, the pad rows
dropped), which is how a checkpoint moves to another mesh or into the
single-device trainer; the streams then start as they were, since a
rank's stream has no counterpart in another topology.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path

import numpy as np
import torch

from come_tpu_torch.models.state import FIELDS, ComEParams, from_numpy

# the state leaves of a checkpoint, as the JAX package names them
LEAVES = FIELDS + ("key", "words_seen")
ROW_LEAVES = ("node_emb", "ctx_emb", "pi")


def save_embedding_word2vec(
    path: str | Path, embeddings: np.ndarray, node_names=None
) -> None:
    """word2vec text format: `V d` header, then `<node> <floats>` lines."""
    emb = np.asarray(embeddings)
    v, d = emb.shape
    names = (
        [str(n) for n in node_names]
        if node_names is not None
        else [str(i) for i in range(v)]
    )
    with open(path, "w") as f:
        f.write(f"{v} {d}\n")
        for name, row in zip(names, emb):
            f.write(name + " " + " ".join(f"{x:.6f}" for x in row) + "\n")


def load_embedding_word2vec(path: str | Path):
    """Returns (embeddings [V, d] f32, names list[str])."""
    with open(path) as f:
        v, d = map(int, f.readline().split())
        names, rows = [], np.empty((v, d), np.float32)
        for i in range(v):
            parts = f.readline().split()
            names.append(parts[0])
            rows[i] = np.asarray(parts[1:], np.float32)
    return rows, names


def threefry_key_data(seed: int) -> np.ndarray:
    """uint32[2] key data of ``jax.random.key(seed)`` (threefry) with JAX's
    64-bit mode off, the JAX package's setting: 0 and the seed's low 32
    bits."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def save_checkpoint(
    path: str | Path,
    params: ComEParams,
    words_seen: float,
    seed: int,
    gen: torch.Generator | None = None,
    host_gen: torch.Generator | None = None,
) -> None:
    """Atomic ``.npz`` checkpoint: the parameters, ``words_seen``, the
    threefry ``key`` made from ``seed`` and, when given, the generators'
    states (module docstring)."""
    _atomic_savez(Path(path), _payload(params, words_seen, seed, gen,
                                       host_gen))


def _payload(params, words_seen, seed, gen, host_gen) -> dict:
    payload = dict(params.to_numpy())
    payload["key"] = threefry_key_data(seed)
    payload["words_seen"] = np.float64(words_seen)
    if gen is not None:
        payload["torch_gen_state"] = gen.get_state().numpy()
        payload["torch_gen_device"] = np.str_(gen.device.type)
    if host_gen is not None:
        payload["torch_host_gen_state"] = host_gen.get_state().numpy()
    return payload


def _atomic_savez(path: Path, payload: dict) -> None:
    fd, tmp = tempfile.mkstemp(dir=path.parent or Path("."), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(
    path: str | Path,
    device,
    gen: torch.Generator | None = None,
    host_gen: torch.Generator | None = None,
    shape: tuple[int, int, int] | None = None,
) -> tuple[ComEParams, float, dict]:
    """Read a checkpoint of either package: one ``.npz``, or the
    per-process files of a sharded one (``<path>.proc<i>.npz``, merged by
    :func:`load_checkpoint_global`; no generator is restored from those).
    Returns (params on ``device``, ``words_seen``, what was restored): each
    generator given takes the saved state when the file has one for its
    device type; ``restored`` maps "gen" and "host_gen" to whether they
    did.  ``shape`` (V, d, K): raise ValueError, before any generator is
    touched, unless the saved parameters have it."""
    if not Path(path).exists() and _proc_path(path, 0).exists():
        leaves, meta = load_checkpoint_global(path)
        return _restore(_logical(leaves, meta), path, device, None, None,
                        shape)
    with np.load(path) as z:
        return _restore(z, path, device, gen, host_gen, shape)


def _restore(z, path, device, gen, host_gen, shape):
    """(params, words_seen, restored) from the leaves ``z`` (an open
    ``.npz`` or a dict of arrays) and the generator states it holds."""
    saved = (*z["node_emb"].shape, z["centroid"].shape[0])
    if shape is not None and saved != tuple(shape):
        raise ValueError(f"checkpoint {path} holds (V, d, K) = {saved}, "
                         f"expected {tuple(shape)}")
    params = from_numpy({k: z[k] for k in FIELDS}, device)
    words_seen = float(z["words_seen"])
    restored = {"gen": False, "host_gen": False}
    keys = set(z.files if hasattr(z, "files") else z)
    if (gen is not None and "torch_gen_state" in keys
            and str(z["torch_gen_device"]) == gen.device.type):
        gen.set_state(torch.from_numpy(np.array(z["torch_gen_state"])))
        restored["gen"] = True
    if host_gen is not None and "torch_host_gen_state" in keys:
        host_gen.set_state(
            torch.from_numpy(np.array(z["torch_host_gen_state"])))
        restored["host_gen"] = True
    return params, words_seen, restored


# ------------------------------------------------- per-process checkpoints


def _proc_path(path: str | Path, process_index: int) -> Path:
    path = Path(path)
    return path.with_name(f"{path.name}.proc{process_index}.npz")


def save_checkpoint_sharded(
    path: str | Path,
    params: ComEParams,
    words_seen: float,
    seed: int,
    process_index: int,
    process_count: int,
    meta: dict | None = None,
    gen: torch.Generator | None = None,
    host_gen: torch.Generator | None = None,
    rows: tuple[int, int] | None = None,
    data_gen: torch.Generator | None = None,
) -> None:
    """This process's file of a sharded checkpoint,
    ``<path>.proc<process_index>.npz``, written atomically: the leaves of
    :func:`save_checkpoint` each with its ``<name>.shape``,
    ``_process_count``, the int topology ``meta`` as ``_meta.<key>`` and
    this process's generator states (``data_gen``, the row-sharded
    trainer's data-row stream, as ``torch_data_gen_state``).  ``rows``
    None: every leaf whole (at model 1 each process holds the whole
    replica); ``(row_start, v_pad)``: ``params``' row leaves are the block
    of a [v_pad, ...] table from ``row_start``, stored as
    ``<name>@<row_start>``."""
    payload = _payload(params, words_seen, seed, gen, host_gen)
    if data_gen is not None:
        payload["torch_data_gen_state"] = data_gen.get_state().numpy()
    for name in LEAVES:
        shape = np.shape(payload[name])
        if rows is not None and name in ROW_LEAVES:
            shape = (rows[1],) + shape[1:]
            payload[f"{name}@{rows[0]}"] = payload.pop(name)
        payload[f"{name}.shape"] = np.asarray(shape, np.int64)
    payload["_process_count"] = np.int64(process_count)
    for k, v in (meta or {}).items():
        payload[f"_meta.{k}"] = np.int64(v)
    _atomic_savez(_proc_path(path, process_index), payload)


def load_checkpoint_sharded(
    path: str | Path,
    process_index: int,
    process_count: int,
    device,
    gen: torch.Generator | None = None,
    host_gen: torch.Generator | None = None,
    shape: tuple[int, int, int] | None = None,
    row_start: int | None = None,
    data_gen: torch.Generator | None = None,
) -> tuple[ComEParams, float, dict]:
    """Restore this process's own file of a sharded checkpoint saved by
    ``process_count`` processes (else ValueError: the elastic path,
    :func:`load_checkpoint_global`, takes other counts), with the
    generator states it holds.  ``row_start`` None: the file's leaves are
    whole (model 1) and come back in node order; else the row leaves are
    the file's ``<name>@<row_start>`` blocks, as saved on the same mesh.
    Returns what :func:`load_checkpoint` does; with ``data_gen`` its
    ``restored`` also says whether that stream was restored."""
    with np.load(_proc_path(path, process_index)) as z:
        saved = int(z["_process_count"])
        if saved != process_count:
            raise ValueError(
                f"checkpoint saved with {saved} processes, running with "
                f"{process_count}: use the elastic restore "
                "(load_checkpoint_global)")
        if row_start is None:
            leaves = _logical(_whole_leaves([z]), load_checkpoint_meta(
                path, process_index))
        else:
            leaves = {k: z[f"{k}@{row_start}"] if k in ROW_LEAVES else z[k]
                      for k in LEAVES}
        keys = [k for k in z.files if k.startswith("torch_")]
        leaves.update({k: z[k] for k in keys})
    out = _restore(leaves, path, device, gen, host_gen, shape)
    if data_gen is not None:
        state = leaves.get("torch_data_gen_state")
        if state is not None:
            data_gen.set_state(torch.from_numpy(np.array(state)))
        out[2]["data_gen"] = state is not None
    return out


def load_checkpoint_meta(path: str | Path, process_index: int = 0) -> dict:
    """Topology metadata of a sharded checkpoint: the ``_meta.*`` ints plus
    ``process_count``; an empty dict when that process's file is absent
    or has none."""
    p = _proc_path(path, process_index)
    if not p.exists():
        return {}
    meta = {}
    with np.load(p) as z:
        for k in z.files:
            if k.startswith("_meta."):
                meta[k[len("_meta."):]] = int(z[k])
        if "_process_count" in z.files:
            meta["process_count"] = int(z["_process_count"])
    return meta


def _whole_leaves(files) -> dict:
    """The state leaves of open per-process ``.npz`` files, each row-sharded
    leaf reassembled from its ``<name>@<row_start>`` blocks (the JAX
    writer's form for leaves a process holds only in part), with a check
    that the blocks cover every row."""
    leaves, shapes, blocks = {}, {}, {}
    for z in files:
        for k in z.files:
            if k.endswith(".shape"):
                shapes[k[:-len(".shape")]] = tuple(int(v) for v in z[k])
            elif "@" in k:
                name, start = k.rsplit("@", 1)
                blocks.setdefault(name, {})[int(start)] = z[k]
            elif k in LEAVES:
                leaves[k] = z[k]
    for name, bl in blocks.items():
        shape = shapes[name]
        if 0 in bl and tuple(bl[0].shape) == shape:
            leaves[name] = bl[0]  # a replicated leaf stored as one block
            continue
        out = np.zeros(shape, next(iter(bl.values())).dtype)
        covered = 0
        for start, b in bl.items():
            out[start:start + b.shape[0]] = b
            covered += b.shape[0]
        if covered != shape[0]:
            raise ValueError(
                f"{name}: merged blocks cover {covered} of {shape[0]} rows")
        leaves[name] = out
    return leaves


def load_checkpoint_global(path: str | Path) -> tuple[dict, dict]:
    """Merge every ``<path>.proc<i>.npz`` of a sharded checkpoint (either
    package's) into whole numpy leaves: the first half of the elastic
    restore.  Returns ``(leaves, meta)`` (:func:`load_checkpoint_meta`)."""
    path = Path(path)
    files = sorted(
        path.parent.glob(path.name + ".proc*.npz"),
        key=lambda p: int(p.name.rsplit(".proc", 1)[1][:-4]),
    )
    if not files:
        raise FileNotFoundError(f"no {path.name}.proc*.npz files")
    opened = [np.load(f) for f in files]
    try:
        saved = int(opened[0]["_process_count"])
        if len(files) != saved:
            raise ValueError(
                f"checkpoint saved by {saved} processes but {len(files)} "
                ".proc files present: the elastic restore needs all of them")
        leaves = _whole_leaves(opened)
    finally:
        for z in opened:
            z.close()
    return leaves, load_checkpoint_meta(path)


def _logical(leaves: dict, meta: dict) -> dict:
    """The leaves in node order: the saved layout's pad rows dropped and,
    where the saving trainer interleaved its rows across a model axis
    (``_meta.interleave``), the interleave undone: ``a[perm]`` with
    ``perm = interleave_permutation(v_real, model)``, since trained row
    ``perm[j]`` holds node j (``come_tpu/parallel/sharded.py:1711-1726``).
    """
    from come_tpu_torch.parallel.exchange import interleave_permutation

    v = int(meta.get("v_real", leaves["node_emb"].shape[0]))
    perm = None
    if meta.get("interleave", 0):
        perm = interleave_permutation(v, int(meta["model"]))

    def rows(a):
        a = a[:v]
        return a if perm is None else a[perm]

    return {k: (rows(a) if k in ROW_LEAVES else a) for k, a in leaves.items()}


def load_logical(path: str | Path,
                 shape: tuple[int, int, int] | None = None
                 ) -> tuple[dict, float]:
    """(leaves in node order, ``words_seen``) of a checkpoint of either
    package: one ``.npz`` or every per-process file of a sharded one,
    merged.  ``shape`` (V, d, K): raise ValueError unless the logical
    parameters have it."""
    if not Path(path).exists() and _proc_path(path, 0).exists():
        leaves, meta = load_checkpoint_global(path)
        leaves = _logical(leaves, meta)
    else:
        with np.load(path) as z:
            leaves = {k: z[k] for k in LEAVES}
    saved = (*leaves["node_emb"].shape, leaves["centroid"].shape[0])
    if shape is not None and saved != tuple(shape):
        raise ValueError(f"checkpoint {path} holds (V, d, K) = {saved}, "
                         f"expected {tuple(shape)}")
    return leaves, float(leaves["words_seen"])
