"""Tracing hooks — port of ``come_tpu/metrics/profiling.py``.

Wraps ``torch.profiler`` so any trainer phase can be traced to a
TensorBoard-readable directory (``torch.profiler.tensorboard_trace_handler``
writes one ``*.pt.trace.json`` there when the block ends):

    from come_tpu_torch.metrics.profiling import trace
    with trace("/tmp/come-trace"):     # no-op when dir is falsy
        trainer.o1_epoch()

CPU activity is always traced; CUDA activity (each kernel's device time)
whenever a card is present.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def trace(trace_dir: str | None):
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    handler = torch.profiler.tensorboard_trace_handler(str(trace_dir))
    with profile(activities=activities, on_trace_ready=handler):
        yield


@contextlib.contextmanager
def annotate(name: str):
    """Named region visible in profiler timelines (record_function)."""
    import torch

    with torch.profiler.record_function(name):
        yield
