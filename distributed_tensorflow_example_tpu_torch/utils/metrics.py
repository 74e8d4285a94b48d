"""Metrics: a JSONL sink and rate tracking (an adapted copy of
``distributed_tensorflow_example_tpu/utils/metrics.py``).

One JSON object per record, the reference's format; stdout only when no
path is given. The TensorBoard event-file sink (``tb_logdir``) arrives
with slice A3c.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, TextIO


class MetricsLogger:
    """Append-only JSONL metrics writer (the one process is the chief).
    With ``registry`` (``obs.registry.Registry``) it counts the records
    it writes."""

    def __init__(self, path: str | None = None, *,
                 tb_logdir: str | None = None, registry=None):
        if tb_logdir:
            raise NotImplementedError("the TensorBoard sink (tb_logdir) "
                                      "arrives with slice A3c")
        self.path = path
        self._f: TextIO | None = None
        self._c_records = (registry.counter(
            "metrics_records_written_total",
            "structured JSONL records written by MetricsLogger")
            if registry is not None else None)
        if path:
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
    """steps/sec and examples/sec over a sliding window (one card: the
    reference's per-chip rate is the same number)."""

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
            out["examples_per_sec_per_chip"] = out["examples_per_sec"]
        self.start(step)
        return out
