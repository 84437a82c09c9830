"""P1, the row-gather floor probe: the CUDA kernels, their plain versions
and the wrappers that pick between them by device.

Port of ``scripts/probe_dma.py`` (its Pallas kernels at ``:36`` and
``:47``), which measured how fast the TPU pages scattered 512 B table rows:
2048 random rows of a [500 000, 128] f32 table, their element 0 summed as a
checksum.  On the card the probe is a gather of N rows of a [V, d] f32 or
bf16 table (16-byte vector loads, several rows in flight per warp) and its
inverse, a scatter-add of N rows back at unique indices (kernel source:
``csrc/row_probe.cu``).  It gives the row-traffic floor of the walk kernels
K1 and K3, whose slots gather and write back rows like these.  The plain
versions are ``table[idx]`` and ``index_add_``.
"""

from __future__ import annotations

import torch

from come_tpu_torch.ops import build

_TYPES = (torch.float32, torch.bfloat16)


def row_gather_probe_reference(table: torch.Tensor, idx: torch.Tensor):
    """Plain version of :func:`row_gather_probe`."""
    rows = table[idx.long()]
    return rows, rows[:, 0].double().sum()


def row_scatter_probe_reference(table, idx, rows):
    """Plain version of :func:`row_scatter_probe`."""
    return table.index_add_(0, idx.long(), rows)


def _check(table, idx):
    if table.dtype not in _TYPES or not table.is_contiguous():
        raise ValueError(f"table must be contiguous, one of {_TYPES}")
    if (table.shape[1] * table.element_size()) % 16:
        raise ValueError("rows must be a multiple of 16 bytes")
    if idx.device != table.device:
        raise ValueError(f"idx on {idx.device}, table on {table.device}")


def row_gather_probe(table: torch.Tensor, idx: torch.Tensor):
    """Gather ``table[idx]`` ([V, d] f32 or bf16, idx int [N]).

    Returns (rows [N, d] of the table's dtype, checksum): the checksum is
    the sum of each row's element 0, a float64 0-dim tensor (the TPU
    probe's).  CPU tensors run the plain version; CUDA tensors launch the
    kernel or raise.  ``row_gather_probe.launches`` counts the launches.
    """
    _check(table, idx)
    if table.device.type == "cpu":
        return row_gather_probe_reference(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"no row probe kernel for device {table.device}")
    idx = idx.to(torch.int32).contiguous()
    out = torch.empty((idx.numel(), table.shape[1]), dtype=table.dtype,
                      device=table.device)
    checksum = torch.zeros(1, dtype=torch.float64, device=table.device)
    code = build.library().come_row_gather(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(),
        checksum.data_ptr(), idx.numel(),
        table.shape[1] * table.element_size(),
        int(table.dtype == torch.bfloat16),
        torch.cuda.current_stream(table.device).cuda_stream,
    )
    row_gather_probe.launches += 1
    build.check(code, "come_row_gather")
    return out, checksum[0]


row_gather_probe.launches = 0


def row_scatter_probe(table, idx, rows):
    """``table[idx[i]] += rows[i]`` in place for UNIQUE ``idx`` (each
    element takes one add, rounded to nearest even in bf16, so the result
    is exact).  Returns ``table``.  CPU tensors run the plain version; CUDA
    tensors launch the kernel or raise.  ``row_scatter_probe.launches``
    counts the launches."""
    _check(table, idx)
    if rows.dtype != table.dtype or rows.shape != (idx.numel(),
                                                    table.shape[1]):
        raise ValueError("rows must be [N, d] of the table's dtype")
    if table.device.type == "cpu":
        return row_scatter_probe_reference(table, idx, rows)
    if table.device.type != "cuda":
        raise ValueError(f"no row probe kernel for device {table.device}")
    idx = idx.to(torch.int32).contiguous()
    rows = rows.contiguous()
    code = build.library().come_row_scatter_add(
        table.data_ptr(), idx.data_ptr(), rows.data_ptr(), idx.numel(),
        table.shape[1], int(table.dtype == torch.bfloat16),
        torch.cuda.current_stream(table.device).cuda_stream,
    )
    row_scatter_probe.launches += 1
    build.check(code, "come_row_scatter_add")
    return table


row_scatter_probe.launches = 0
