"""G1, the GMM's Cholesky factor and inverse covariances: the CUDA kernel
(``csrc/gmm_factor.cu``), its plain version and the wrappers that pick
between them by device.

The port's own kernel: the JAX package factors each M-step's covariances
with XLA's ``jax.lax.linalg.cholesky`` (``come_tpu/losses/gmm.py:52``,
``:241``) inside one jitted EM program.  :func:`gmm_factor` returns the
lower factors of ``cov / nk + reg_covar I`` with each matrix's info flag as
a device tensor (0, or the 1-based column of the first non-positive pivot,
``torch.linalg.cholesky_ex``'s convention), so the EM loop reads the flags
when it checks whether to stop and never at a factor call; the kernel reads
nothing back, so a captured EM iteration can hold it.
:func:`gmm_inverse` gives ``(L L^T)^-1``.

CPU tensors take the plain versions (``torch.linalg.cholesky_ex``,
``torch.cholesky_inverse``); CUDA tensors launch the kernels or raise.
Up to ``SHARED_D`` = 128 a CTA holds its matrix in shared memory; past it
the matrix lives in an f64 scratch in device memory (``nmat`` [dp, dp],
dp = d rounded up to 16) that the wrapper allocates, and only each panel's
inverted diagonal block is in shared memory.  Each wrapper counts the
kernels it launches in ``launches``; a call made while its stream is being
captured into a graph launches nothing: it adds one to ``captured``
instead, and the graph's plan adds the factor launches of the runs the
device made (``launch_plan.GraphPlan.ran``).
"""

from __future__ import annotations

import torch

from come_tpu_torch.ops import build

SHARED_D = 128  # the widest d whose matrix a CTA holds in shared memory
_READY: set = set()  # devices whose shared-memory caps are raised


def gmm_factor_reference(cov: torch.Tensor, nk: torch.Tensor,
                         reg_covar: float):
    """Plain version of :func:`gmm_factor`: (L, info)."""
    d = cov.shape[-1]
    a = cov / nk[..., None, None]
    a = a + reg_covar * torch.eye(d, dtype=cov.dtype, device=cov.device)
    return torch.linalg.cholesky_ex(a)


def gmm_inverse_reference(chol: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gmm_inverse`."""
    return torch.cholesky_inverse(chol)


def _setup(lib, dev: torch.device, capturing: bool) -> None:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx in _READY:
        return
    if capturing:
        raise RuntimeError("gmm_factor: the first call on a device must be "
                           "made outside a stream capture")
    with torch.cuda.device(idx):
        build.check(lib.come_gmm_factor_setup(), "come_gmm_factor_setup")
    _READY.add(idx)


def _check(x: torch.Tensor, name: str) -> None:
    if x.dtype != torch.float32 or x.dim() < 2 or x.shape[-1] != x.shape[-2]:
        raise ValueError(f"{name} must be f32 [..., d, d], got {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"no gmm_factor kernel for device {x.device}")


def _work(x: torch.Tensor, nmat: int, d: int):
    """The kernels' f64 scratch past SHARED_D (None up to it): nmat
    matrices of d rounded up to 16.  Allocated on the current stream, so a
    captured call takes it from the graph's pool."""
    if d <= SHARED_D:
        return None
    dp = -(-d // 16) * 16
    return torch.empty(nmat * dp * dp, dtype=torch.float64, device=x.device)


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def gmm_factor(cov: torch.Tensor, nk: torch.Tensor, reg_covar: float):
    """Lower Cholesky factors of ``cov / nk + reg_covar I`` (``cov`` f32
    [..., d, d], only its lower triangle read; ``nk`` [...]) and their info
    flags, int32 [...]: 0, or k + 1 for the first column k whose pivot is
    not positive (the factor is then not to be used).  Returns (L, info)."""
    if cov.device.type == "cpu":
        return gmm_factor_reference(cov, nk, reg_covar)
    _check(cov, "cov")
    if nk.shape != cov.shape[:-2] or nk.device != cov.device:
        raise ValueError(f"nk must be {tuple(cov.shape[:-2])} on "
                         f"{cov.device}, got {tuple(nk.shape)}")
    lib = build.library()
    capturing = torch.cuda.is_current_stream_capturing()
    _setup(lib, cov.device, capturing)
    cov = cov.contiguous()
    nk = nk.to(torch.float32).contiguous()
    d = cov.shape[-1]
    nmat = cov.numel() // (d * d)
    L = torch.empty_like(cov)
    info = torch.empty(cov.shape[:-2], dtype=torch.int32, device=cov.device)
    work = _work(cov, nmat, d)
    code = lib.come_gmm_factor(
        cov.data_ptr(), nk.data_ptr(), float(reg_covar), L.data_ptr(),
        info.data_ptr(), nmat, d, _ptr(work),
        torch.cuda.current_stream(cov.device).cuda_stream)
    build.check(code, "come_gmm_factor")
    if capturing:
        gmm_factor.captured += 1  # launched by each run of the graph
    else:
        gmm_factor.launches += 1
    return L, info


def gmm_inverse(chol: torch.Tensor) -> torch.Tensor:
    """``(L L^T)^-1`` of lower factors ``chol`` f32 [..., d, d]."""
    if chol.device.type == "cpu":
        return gmm_inverse_reference(chol)
    _check(chol, "chol")
    lib = build.library()
    capturing = torch.cuda.is_current_stream_capturing()
    _setup(lib, chol.device, capturing)
    chol = chol.contiguous()
    d = chol.shape[-1]
    inv = torch.empty_like(chol)
    nmat = chol.numel() // (d * d)
    work = _work(chol, nmat, d)
    code = lib.come_gmm_inverse(
        chol.data_ptr(), inv.data_ptr(), nmat, d, _ptr(work),
        torch.cuda.current_stream(chol.device).cuda_stream)
    build.check(code, "come_gmm_inverse")
    if capturing:
        gmm_inverse.captured += 1
    else:
        gmm_inverse.launches += 1
    return inv


gmm_factor.launches = gmm_factor.captured = 0
gmm_inverse.launches = gmm_inverse.captured = 0
