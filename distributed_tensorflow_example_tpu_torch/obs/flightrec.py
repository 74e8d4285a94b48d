"""Black-box flight recorder: incident bundles written at the failure
seams (a copy of ``distributed_tensorflow_example_tpu/obs/
flightrec.py``).

The span ring runs always-on (``obs/trace.py`` ``arm_always_on``), and
the serving stack's failure seams call :meth:`FlightRecorder.incident`
when something breaks:

=========================  ==============================================
bundle ``cause``            seam that fires it
=========================  ==============================================
``watchdog_stall``          ``PredictServer.health()`` sees the engine
                            heartbeat aged past ``stall_after_s``
``engine_fatal_rebuild``    the engine's fatal handler, before it fails
                            every in-flight request
``poison_eviction``         the engine evicting the newest-admitted slot
                            after a repeated shared-step failure
``slo_burn``                ``/stats/history``'s SLO evaluation finding
                            a multi-window burn breach
=========================  ==============================================

Each incident writes ONE timestamped JSON bundle to ``--incident_dir``
(temp file + ``os.replace``: a crash mid-write never leaves half a
bundle), rate-limited PER CAUSE (default one per 30 s). A bundle holds
the cause and detail, the newest spans of the ring (read without
removing them), the registry snapshot ``/metrics`` renders, the
request-log tail, the caller's context and the config fingerprint.

``--flight_recorder off`` leaves serving byte- and dispatch-identical to
the armed run: arming only adds observability.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Any, Callable

from . import trace as obs_trace
from ..utils.logging import get_logger

log = get_logger("flightrec")


def config_fingerprint(config: dict[str, Any]) -> str:
    """Stable short hash of a knob dict — the "what was this process
    actually running" field incident triage starts from."""
    blob = json.dumps(config, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


class FlightRecorder:
    """One process's incident-bundle writer.

    ``snapshot_fn`` returns the registry snapshot to embed (the
    server's ``_metrics_snapshot`` — the SAME atomic read ``/metrics``
    renders); ``config`` is the knob dict fingerprinted into every
    bundle; ``counter``/``suppressed_counter`` (optional registry
    counters) publish bundle/rate-limit activity; ``clock`` is
    injectable so rate-limit unit tests need no sleeps.
    """

    def __init__(self, incident_dir: str, *, process: str = "serving",
                 snapshot_fn: Callable[[], dict] | None = None,
                 config: dict[str, Any] | None = None,
                 request_log_path: str | None = None,
                 max_spans: int = 512, min_interval_s: float = 30.0,
                 counter=None, suppressed_counter=None,
                 clock=time.monotonic):
        if not incident_dir:
            raise ValueError("FlightRecorder needs an incident_dir")
        self.incident_dir = incident_dir
        self.process = process
        self.snapshot_fn = snapshot_fn
        self.config = dict(config or {})
        self.request_log_path = request_log_path
        self.max_spans = int(max_spans)
        self.min_interval_s = float(min_interval_s)
        self.clock = clock
        self._counter = counter
        self._suppressed = suppressed_counter
        self._lock = threading.Lock()
        self._last_by_cause: dict[str, float] = {}
        self._seq = 0
        os.makedirs(incident_dir, exist_ok=True)

    # -- the one write path -------------------------------------------
    def incident(self, cause: str, detail: str = "",
                 extra: dict[str, Any] | None = None) -> str | None:
        """Write one incident bundle; returns its path, or None when
        the per-cause rate limit suppressed it. Never raises into the
        failure seam that called it — an incident dump that killed the
        scheduler thread would turn observability into an outage."""
        now = self.clock()
        with self._lock:
            last = self._last_by_cause.get(cause)
            if last is not None and now - last < self.min_interval_s:
                if self._suppressed is not None:
                    self._suppressed.inc()
                return None
            self._last_by_cause[cause] = now
            self._seq += 1
            seq = self._seq
        # the counter advances BEFORE the registry snapshot lands in
        # the bundle, so the bundle is self-consistent with the live
        # /metrics page (a bundle claiming incidents_total=0 while
        # being incident #1 would fail the snapshot-vs-page contract);
        # it therefore counts incidents CAPTURED — a failed write below
        # is logged, and the rate-limit stamp is rolled back so the
        # NEXT occurrence retries instead of being suppressed for a
        # bundle that never landed
        if self._counter is not None:
            self._counter.inc()
        try:
            path = self._write(cause, detail, extra or {}, seq)
        except Exception as e:    # noqa: BLE001 — see docstring
            log.warning("incident bundle for %s failed: %s", cause, e)
            with self._lock:
                if self._last_by_cause.get(cause) == now:
                    del self._last_by_cause[cause]
            return None
        log.warning("incident bundle (%s): %s", cause, path)
        return path

    def _write(self, cause: str, detail: str, extra: dict,
               seq: int) -> str:
        rec = obs_trace.recorder()
        spans = rec.tail(self.max_spans, process=self.process)
        bundle = {
            "cause": cause,
            "detail": detail,
            "process": self.process,
            "time_unix": time.time(),
            "clock": time.perf_counter(),
            "config": self.config,
            "config_fingerprint": config_fingerprint(self.config),
            "spans": [[p, lane, name, t0, t1, args]
                      for p, lane, name, t0, t1, args in spans],
            "spans_recorded": rec.spans_recorded,
            "events_dropped": rec.events_dropped,
            "tracing_enabled": rec.enabled,
            **extra,
        }
        if self.snapshot_fn is not None:
            try:
                bundle["registry"] = self.snapshot_fn()
            except Exception as e:     # noqa: BLE001 — partial > none
                bundle["registry_error"] = f"{type(e).__name__}: {e}"
        if self.request_log_path:
            bundle["request_log_tail"] = self._log_tail()
        # the wall-clock millisecond stamp keeps names unique ACROSS
        # restarts: a supervisor-restarted process re-seeds _seq at 1,
        # and a seq-only name would os.replace the crashed run's
        # bundle — exactly the evidence a black box exists to keep
        fname = (f"incident-{self.process}-{cause}-"
                 f"{int(bundle['time_unix'] * 1e3)}-{seq:03d}.json")
        path = os.path.join(self.incident_dir, fname)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(bundle, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path

    def _log_tail(self, max_lines: int = 50,
                  max_bytes: int = 64 * 1024) -> list[str]:
        """Last lines of the request log (bounded read — the log can be
        arbitrarily long; the bundle must not be)."""
        try:
            with open(self.request_log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - max_bytes))
                lines = f.read().decode(errors="replace").splitlines()
            return lines[-max_lines:]
        except OSError:
            return []
