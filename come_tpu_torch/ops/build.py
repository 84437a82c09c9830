"""Build and load the port's CUDA kernels.

``come_tpu_torch/csrc/*.cu`` compile with ``nvcc`` for ``sm_90a``, one
``nvcc`` process per source, all started together, and link into one
shared library with a plain C interface, loaded with ``ctypes``.  The
sources include no PyTorch headers, so a build takes seconds.  The library
lands in ``come_tpu_torch/_build/`` under a name keyed on a hash of the
sources and flags, so an edit rebuilds and an unchanged tree reuses it.
Nothing is built when the package is imported: the first wrapper call on a
CUDA tensor builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_F = ctypes.c_float
# C signatures (csrc/walk_sgns.cu, star_sgns.cu, sgns_fused.cu,
# row_probe.cu, smem_probe.cu, star_probe.cu, floor_probe.cu): every pointer
# and the stream as c_void_p, ints as c_int, seeds as c_uint32, scalars as
# c_float.  Each returns an int (0 or a CUDA error code) unless RESTYPES
# says otherwise.
SIGNATURES = {
    "come_walk_sgns_step": [_P] * 12 + [_I] * 10 + [_U, _F, _F, _P],
    "come_walk_sgns_gen_step": [_P] * 16 + [_I] * 9 + [_U, _F, _F, _P],
    "come_star_sgns_step": [_P] * 9 + [_I] * 5 + [_F, _F, _P],
    "come_fused_sgns_step": [_P] * 12 + [_I] * 4 + [_F, _F, _P],
    "come_fused_sgns_step_tied": [_P] * 11 + [_I] * 4 + [_F, _F, _P],
    "come_row_gather": [_P] * 4 + [_I] * 3 + [_P],
    "come_row_scatter_add": [_P] * 3 + [_I] * 3 + [_P],
    "come_smem_probe": [_P, _P, _I, _P],
    "come_smem_optin": [],
    "come_cuda_error_name": [_I],
    "come_star_probe_step": [_P] * 11 + [_I] * 7 + [_F, _F, _P],
    "come_floor_probe": [_I] + [_P] * 9 + [_I] * 3 + [_P],
}
RESTYPES = {"come_cuda_error_name": ctypes.c_char_p}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcome_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> tuple[Path, float]:
    """Compile the kernels unless this source hash is built already.

    Returns (library path, build seconds; 0.0 when reused).  ``verbose``
    adds ``-Xptxas -v`` and prints the compiler's report (registers, shared
    memory, spills per kernel)."""
    out = library_path()
    if out.exists() and not verbose:
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    ptxas = ["-Xptxas", "-v"] if verbose else []
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in srcs]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(srcs, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    codes = [p.returncode for p in procs]
    if not any(codes):
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
             *(str(o) for o in objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        logs.append(link.stdout)
        codes.append(link.returncode)
    secs = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    if any(codes):
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({codes}):\n" + "\n".join(logs))
    if verbose:
        print("\n".join(logs))
    os.replace(tmp, out)
    return out, secs


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library, with argtypes and restype declared."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = RESTYPES.get(name, ctypes.c_int)
    return lib


class CudaError(RuntimeError):
    """A C entry point returned a CUDA error: ``code`` and its ``name``."""

    def __init__(self, entry: str, code: int):
        self.code = code
        self.name = library().come_cuda_error_name(code).decode()
        super().__init__(f"{entry} failed with CUDA error {code} "
                         f"({self.name})")


def check(code: int, name: str) -> None:
    """Raise :class:`CudaError` for a non-zero CUDA error code returned by
    the C entry point ``name``."""
    if code != 0:
        raise CudaError(name, code)
