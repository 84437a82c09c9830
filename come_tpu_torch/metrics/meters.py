"""Observability: throughput meters and a structured scalar sink.

Port of ``come_tpu/metrics/meters.py``, plain Python kept as its own copy
(the port imports nothing of the JAX package).

The reference's only observability was words/sec prints in the hogwild
monitor loop and matplotlib PNGs (SURVEY.md §5).  Here: a first-class
edge-updates/s meter (the BASELINE.json:2 north-star metric) and a JSONL
scalar log usable from the trainer loop.
"""

from __future__ import annotations

import json
import time
from pathlib import Path


class ThroughputMeter:
    """Tracks pair-updates/s across timed windows.

    Usage:
        meter = ThroughputMeter()
        with meter.window(pairs=1_000_000):
            run_epoch()
        meter.rate  # pairs/s over all closed windows
    """

    def __init__(self):
        self.total_pairs = 0.0
        self.total_seconds = 0.0
        self._t0 = None
        self._pending = 0.0

    def window(self, pairs: float):
        meter = self

        class _W:
            def __enter__(self_w):
                meter._t0 = time.perf_counter()
                meter._pending = pairs
                return meter

            def __exit__(self_w, *exc):
                if exc[0] is None:
                    meter.total_seconds += time.perf_counter() - meter._t0
                    meter.total_pairs += meter._pending
                meter._t0 = None
                return False

        return _W()

    @property
    def rate(self) -> float:
        return self.total_pairs / self.total_seconds if self.total_seconds else 0.0


class ScalarLog:
    """Append-only JSONL scalar sink: one record per step/iteration."""

    def __init__(self, path: str | Path | None = None):
        self.path = Path(path) if path else None
        self.records: list[dict] = []

    def log(self, step: int, **scalars) -> dict:
        rec = {"step": step, "time": time.time(), **scalars}
        self.records.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec
