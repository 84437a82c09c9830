"""P2, the shared-memory capacity probe: the CUDA kernel, its plain version
and the wrapper that picks between them by device.

Port of ``scripts/probe_vmem.py`` (its Pallas kernel at ``:12``, the call at
``:15``), which searched for the largest VMEM scratch a TPU kernel may hold.
On the card the counterpart is a block's dynamic shared memory (kernel
source ``csrc/smem_probe.cu``): :func:`smem_probe` launches a kernel that
holds ``nbytes`` of it as an [n, 128] f32 buffer, copies ``x[0, :]`` into
row 0 and returns that row's sum.  ``tools/probe_smem.py`` runs the
capacity search.
"""

from __future__ import annotations

import torch

from come_tpu_torch.ops import build

ROW = 128


def smem_probe_reference(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """Plain version of :func:`smem_probe`: the sum of ``x[0, :128]`` (a
    plain tensor op holds no shared memory, so ``nbytes`` is not read)."""
    return x[0, :ROW].sum()


def smem_probe(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """Sum of ``x[0, :128]`` (``x`` f32 [>=1, >=128], contiguous) from a
    kernel holding ``nbytes`` of dynamic shared memory.

    Returns a 0-dim f32 tensor.  CPU tensors run the plain version; CUDA
    tensors launch the kernel (counted in ``smem_probe.launches``) or raise
    ``build.CudaError`` with the card's refusal (``cudaErrorInvalidValue``
    past the per-block opt-in limit)."""
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] < ROW:
        raise ValueError("x must be f32 [rows, >= 128]")
    if x.device.type == "cpu":
        return smem_probe_reference(x, nbytes)
    if x.device.type != "cuda":
        raise ValueError(f"no smem probe kernel for device {x.device}")
    x = x.contiguous()
    out = torch.empty(1, dtype=torch.float32, device=x.device)
    code = build.library().come_smem_probe(
        x.data_ptr(), out.data_ptr(), int(nbytes),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(code, "come_smem_probe")
    smem_probe.launches += 1  # only a launch the card took
    return out[0]


smem_probe.launches = 0


def smem_optin_bytes() -> int:
    """``cudaDevAttrMaxSharedMemoryPerBlockOptin`` of the current card."""
    return int(build.library().come_smem_optin())
