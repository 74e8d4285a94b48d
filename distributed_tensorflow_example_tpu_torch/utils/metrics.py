"""Metrics: a JSONL sink and rate tracking (an adapted copy of
``distributed_tensorflow_example_tpu/utils/metrics.py``).

One JSON object per record, the reference's format; stdout only when no
path is given. Rank 0 writes, as the reference's process 0 does. The
TensorBoard event-file sink (``tb_logdir``) arrives with slice A3c-4.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, TextIO

from ..runtime import distributed


class MetricsLogger:
    """Append-only JSONL metrics writer; rank 0 (the chief) writes, the
    other ranks' records go nowhere. With ``registry``
    (``obs.registry.Registry``) it counts the records it writes."""

    def __init__(self, path: str | None = None, *,
                 tb_logdir: str | None = None, registry=None):
        if tb_logdir:
            raise NotImplementedError("the TensorBoard sink (tb_logdir) "
                                      "arrives with slice A3c-4")
        self.path = path
        self._f: TextIO | None = None
        self._c_records = (registry.counter(
            "metrics_records_written_total",
            "structured JSONL records written by MetricsLogger")
            if registry is not None else None)
        if path and distributed.process_index() == 0:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            self._f = open(path, "a", buffering=1)

    def log(self, record: dict[str, Any]) -> None:
        record = dict(record, time=time.time())
        line = json.dumps(record, default=float)
        if self._f is not None:
            self._f.write(line + "\n")
            if self._c_records is not None:
                self._c_records.inc()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class RateTracker:
    """steps/sec and examples/sec(/chip) over a sliding window; a rank
    drives one card, so the chips are the ranks (the reference's device
    count)."""

    def __init__(self, batch_size: int = 0):
        self.batch_size = batch_size
        self._t0: float | None = None
        self._s0 = 0

    def start(self, step: int) -> None:
        self._t0 = time.perf_counter()
        self._s0 = step

    def rates(self, step: int) -> dict[str, float]:
        """Rates since the last start(); restarts the window."""
        now = time.perf_counter()
        if self._t0 is None or step <= self._s0:
            self.start(step)
            return {}
        dt = now - self._t0
        steps = step - self._s0
        out = {"steps_per_sec": steps / dt, "sec_per_step": dt / steps}
        if self.batch_size:
            out["examples_per_sec"] = steps * self.batch_size / dt
            out["examples_per_sec_per_chip"] = (
                out["examples_per_sec"] / distributed.process_count())
        self.start(step)
        return out
