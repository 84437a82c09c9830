"""Build and load the host walker library (g++ at first use).

Port of ``come_tpu/native/build.py`` with one change: a failed build raises
with the compiler's output instead of returning None, so no caller can
fall back silently.  The library lands in ``come_tpu_torch/_build/`` under
a name keyed on a hash of ``walker.cpp`` and the flags, written to a
temporary name and renamed, so processes that build at once do not see a
half-written file.  Nothing is built when the package is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

SRC = Path(__file__).resolve().parent / "walker.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_P32 = ctypes.POINTER(ctypes.c_int32)
# come_random_walks_batched(indptr, indices, starts, num_batches, batch,
#                           length, seeds, restart_prob, outs, num_threads)
ARGTYPES = [_P32, _P32, _P32, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_uint64), ctypes.c_float,
            ctypes.POINTER(_P32), ctypes.c_int32]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libcomewalk_{h.hexdigest()[:16]}.so"


def build(cxx: str = "g++", out: Path | None = None) -> Path:
    """Compile ``walker.cpp`` into ``out`` (default :func:`library_path`)
    unless it exists.  Raises RuntimeError, with the compiler's output,
    when ``cxx`` is missing or fails."""
    out = Path(out) if out is not None else library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC), "-lpthread"]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"cannot build the host walker: compiler {cxx!r} "
                           f"not found") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{' '.join(cmd)} failed with exit code {res.returncode}:\n"
            f"{res.stderr}{res.stdout}")
    os.replace(tmp, out)
    return out


@functools.cache
def load_native() -> ctypes.CDLL:
    """The walker library with its signature declared, built on first use.
    A ``ctypes.CDLL`` call releases the GIL, so the walker's threads run
    beside the Python loop that launches the kernels."""
    lib = ctypes.CDLL(str(build()))
    lib.come_random_walks_batched.argtypes = ARGTYPES
    lib.come_random_walks_batched.restype = None
    return lib
