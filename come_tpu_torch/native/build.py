"""Build and load the native host libraries (g++ at first use): the walker
(``walker.cpp``) and the star layout's packing (``stars.cpp``).

Port of ``come_tpu/native/build.py`` with one change: a failed build raises
with the compiler's output instead of returning None, so no caller can
fall back silently.  Each library lands in ``come_tpu_torch/_build/`` under
a name keyed on a hash of its source and the flags, written to a
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
STARS_SRC = Path(__file__).resolve().parent / "stars.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_P32 = ctypes.POINTER(ctypes.c_int32)
# come_random_walks_batched(indptr, indices, starts, num_batches, batch,
#                           length, seeds, restart_prob, outs, num_threads)
ARGTYPES = [_P32, _P32, _P32, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_uint64), ctypes.c_float,
            ctypes.POINTER(_P32), ctypes.c_int32]


_NAMES = {SRC: "libcomewalk", STARS_SRC: "libcomestars"}


def library_path(src: Path = SRC) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"{_NAMES[src]}_{h.hexdigest()[:16]}.so"


def build(cxx: str = "g++", out: Path | None = None, src: Path = SRC) -> Path:
    """Compile ``src`` (default ``walker.cpp``) into ``out`` (default
    :func:`library_path`) unless it exists.  Raises RuntimeError, with the
    compiler's output, when ``cxx`` is missing or fails."""
    out = Path(out) if out is not None else library_path(src)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(src), "-lpthread"]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"cannot build {src.name}: compiler {cxx!r} "
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


_I64 = ctypes.c_int64
_P64 = ctypes.POINTER(_I64)
# come_star_sort(u, v, E, num_nodes, dst, hubs, starts, ends) -> n_seg
SORT_ARGTYPES = [_P32, _P32, _I64, _I64, _P32, _P32, _P64, _P64]
# come_star_pack(hubs, starts, ends, n_seg, dst, row_slots, max_fanout,
#                slots, meta, cap) -> slots used, or -1
PACK_ARGTYPES = [_P32, _P64, _P64, _I64, _P32, ctypes.c_int32,
                 ctypes.c_int32, _P32, _P32, _I64]


@functools.cache
def load_stars() -> ctypes.CDLL:
    """The star-layout library with its signatures declared, built on
    first use."""
    lib = ctypes.CDLL(str(build(src=STARS_SRC)))
    lib.come_star_sort.argtypes = SORT_ARGTYPES
    lib.come_star_pack.argtypes = PACK_ARGTYPES
    lib.come_star_sort.restype = lib.come_star_pack.restype = _I64
    return lib
