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
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path

import numpy as np
import torch

from come_tpu_torch.models.state import FIELDS, ComEParams, from_numpy


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
    payload = dict(params.to_numpy())
    payload["key"] = threefry_key_data(seed)
    payload["words_seen"] = np.float64(words_seen)
    if gen is not None:
        payload["torch_gen_state"] = gen.get_state().numpy()
        payload["torch_gen_device"] = np.str_(gen.device.type)
    if host_gen is not None:
        payload["torch_host_gen_state"] = host_gen.get_state().numpy()
    _atomic_savez(Path(path), payload)


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
    """Read a checkpoint of either package.  Returns (params on ``device``,
    ``words_seen``, what was restored): each generator given takes the
    saved state when the file has one for its device type; ``restored``
    maps "gen" and "host_gen" to whether they did.  ``shape`` (V, d, K):
    raise ValueError, before any generator is touched, unless the saved
    parameters have it."""
    with np.load(path) as z:
        saved = (*z["node_emb"].shape, z["centroid"].shape[0])
        if shape is not None and saved != tuple(shape):
            raise ValueError(f"checkpoint {path} holds (V, d, K) = {saved}, "
                             f"expected {tuple(shape)}")
        params = from_numpy({k: z[k] for k in FIELDS}, device)
        words_seen = float(z["words_seen"])
        restored = {"gen": False, "host_gen": False}
        if (gen is not None and "torch_gen_state" in z.files
                and str(z["torch_gen_device"]) == gen.device.type):
            gen.set_state(torch.from_numpy(z["torch_gen_state"].copy()))
            restored["gen"] = True
        if host_gen is not None and "torch_host_gen_state" in z.files:
            host_gen.set_state(
                torch.from_numpy(z["torch_host_gen_state"].copy()))
            restored["host_gen"] = True
    return params, words_seen, restored
