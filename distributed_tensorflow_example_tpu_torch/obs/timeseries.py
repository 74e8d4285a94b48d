"""Metric time-series: a bounded ring of registry snapshots and pure
window queries (a copy of ``distributed_tensorflow_example_tpu/obs/
timeseries.py``, standard library only).

- :class:`SnapshotSampler` captures the registry's atomic snapshot (the
  dict ``/metrics`` renders) into a bounded ring of ``(t, snapshot)``
  pairs every ``interval_s``. The clock is injectable and
  :meth:`~SnapshotSampler.sample` is an ordinary method, so tests drive
  time by hand. Sampling only reads the registry: no request-path code
  looks for a sampler, so arming one changes no served byte.
- Window queries over a ``[(t, snapshot), ...]`` history:
  :func:`window`, :func:`delta`, :func:`rate_per_s`, :func:`quantile`
  (the bucket delta between the window's edge samples through
  :func:`~.prom.quantile_from_parsed`) and :func:`good_below` (the
  interpolated count of window observations at or under a bound: the
  latency SLI's numerator).
- :func:`rollup` merges N histories into one, each first shifted into
  the caller's clock by a given offset, binned on a common grid and
  merged per bin with :func:`~.registry.merge_snapshots`; only bins every
  history covers are emitted.

:func:`to_payload` / :func:`parse_payload` define the
``GET /stats/history`` JSON shape (samples as ``[t, snapshot]`` pairs).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Iterable, Sequence

from . import prom
from .registry import merge_snapshots
from ..utils.logging import get_logger

log = get_logger("timeseries")

#: one history sample: (capture time in the owning process's
#: perf_counter clock, registry snapshot dict)
Sample = tuple[float, dict]


class SnapshotSampler:
    """Bounded ring of ``(t, snapshot)`` captures of one snapshot
    function.

    ``snapshot_fn`` is the server's ``_metrics_snapshot`` (gauges
    freshened, atomic); ``clock`` is injectable so tests never sleep;
    ``on_sample`` (optional) runs after every capture with the sampler
    itself — the server hangs its SLO evaluation + burn-rate breach
    check there. A raising ``on_sample`` is logged and swallowed: the
    sampler is observability, and observability must never take the
    serving path down.

    Thread model: :meth:`sample` is safe from any thread (ring
    mutations under one lock); :meth:`start` takes the first capture
    itself, so a just-started server already has its zero baseline, and
    then runs it on a daemon thread every ``interval_s``;
    :meth:`stop` parks the thread promptly even mid-wait.
    """

    def __init__(self, snapshot_fn: Callable[[], dict], *,
                 interval_s: float = 1.0, max_samples: int = 600,
                 clock: Callable[[], float] = time.perf_counter,
                 on_sample: Callable[["SnapshotSampler"], None]
                 | None = None):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        if max_samples < 2:
            raise ValueError(f"max_samples must be >= 2 (window math "
                             f"needs two edges), got {max_samples}")
        self.snapshot_fn = snapshot_fn
        self.interval_s = float(interval_s)
        self.max_samples = int(max_samples)
        self.clock = clock
        self.on_sample = on_sample
        self._lock = threading.Lock()
        self._ring: list[Sample] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- capture -------------------------------------------------------
    def sample(self) -> Sample:
        """Capture one ``(t, snapshot)`` pair into the ring (oldest
        sample drops at ``max_samples``) and run ``on_sample``.
        Returns the new sample."""
        s = (self.clock(), self.snapshot_fn())
        with self._lock:
            self._ring.append(s)
            if len(self._ring) > self.max_samples:
                del self._ring[0]
        if self.on_sample is not None:
            try:
                self.on_sample(self)
            except Exception as e:      # noqa: BLE001 — see docstring
                log.warning("on_sample callback failed: %s", e)
        return s

    def peek(self) -> Sample:
        """One ``(t, snapshot)`` capture WITHOUT storing it or running
        ``on_sample`` — the ``/stats/history`` freshness sample. The
        ring holds only cadence samples, so concurrent pollers can
        never erode its time coverage below the burn windows it was
        sized for."""
        return (self.clock(), self.snapshot_fn())

    def history(self) -> list[Sample]:
        """A consistent copy of the ring, oldest first."""
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # -- background cadence --------------------------------------------
    def start(self) -> "SnapshotSampler":
        """Take the first capture on the calling thread, then one every
        ``interval_s`` on a daemon thread: the zero baseline exists when
        ``start`` returns, however late the thread first runs."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def capture():
            try:
                self.sample()
            except Exception as e:      # noqa: BLE001 — keep sampling
                log.warning("history sample failed: %s", e)

        capture()

        def loop():
            while not self._stop.wait(self.interval_s):
                capture()

        self._thread = threading.Thread(target=loop,
                                        name="snapshot-sampler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# ---------------------------------------------------------------------------
# pure window queries over [(t, snapshot), ...]
# ---------------------------------------------------------------------------

def window(history: Sequence[Sample], seconds: float | None,
           now: float | None = None) -> list[Sample]:
    """The sub-history within ``seconds`` of ``now`` (default: the
    newest sample's own stamp — so a quiesced history windows against
    itself, not against a wall clock that kept running). An explicit
    ``now`` cuts BOTH ends: samples newer than ``now`` are excluded,
    so an offline replay at a mid-incident instant can never compute
    burn from data that had not happened yet. ``seconds`` None/<=0
    keeps every sample up to ``now``."""
    hist = list(history)
    if not hist:
        return hist
    if now is not None:
        t_end = float(now)
        hist = [s for s in hist if s[0] <= t_end]
    else:
        t_end = hist[-1][0]
    if seconds is None or seconds <= 0:
        return hist
    lo = t_end - float(seconds)
    return [s for s in hist if s[0] >= lo]


def _edges(win: Sequence[Sample]) -> tuple[Sample, Sample] | None:
    return (win[0], win[-1]) if len(win) >= 2 else None


def delta(win: Sequence[Sample], name: str):
    """Change of metric ``name`` across the window: counters/gauges
    return ``last - first`` (0 when the window has under two samples
    or the name is absent); histograms return a de-accumulated record
    ``{"buckets": [(le, count)], "inf", "sum", "count"}`` of ONLY the
    window's observations."""
    e = _edges(win)
    if e is None:
        return 0
    (_, a), (_, b) = e
    ra, rb = a.get(name), b.get(name)
    if rb is None:
        return 0
    if rb["type"] in ("counter", "gauge"):
        va = ra["value"] if ra is not None else 0
        return rb["value"] - va
    buckets_a = {le: c for le, c in (ra or {}).get("buckets", ())}
    return {
        "buckets": [(le, c - buckets_a.get(le, 0))
                    for le, c in rb.get("buckets", ())],
        "inf": rb.get("inf", 0) - (ra or {}).get("inf", 0),
        "sum": rb.get("sum", 0.0) - (ra or {}).get("sum", 0.0),
        "count": rb.get("count", 0) - (ra or {}).get("count", 0),
    }


def duration_s(win: Sequence[Sample]) -> float:
    """Window span in seconds (0.0 with under two samples)."""
    e = _edges(win)
    return (e[1][0] - e[0][0]) if e else 0.0


def rate_per_s(win: Sequence[Sample], name: str) -> float:
    """Counter rate over the window: delta / span (0.0 when the span
    is empty — a one-sample history has no rate, not an infinite
    one)."""
    dt = duration_s(win)
    if dt <= 0:
        return 0.0
    d = delta(win, name)
    if isinstance(d, dict):
        raise ValueError(f"{name!r} is a histogram — rate_per_s reads "
                         "counters/gauges (use delta() for buckets)")
    return d / dt


def _hist_delta_as_parsed(win: Sequence[Sample], name: str
                          ) -> dict[str, float] | None:
    """The window's histogram delta in :func:`~.prom.parse` shape, so
    quantiles ride :func:`~.prom.quantile_from_parsed` unchanged."""
    d = delta(win, name)
    if not isinstance(d, dict) or d["count"] <= 0:
        return None
    parsed: dict[str, float] = {f"{name}_count": d["count"]}
    acc = 0
    for le, c in d["buckets"]:
        acc += c
        parsed[f'{name}_bucket{{le="{prom._fmt_le(le)}"}}'] = acc
    return parsed


def quantile(win: Sequence[Sample], name: str, q: float) -> float:
    """Histogram quantile of ONLY the window's observations (seconds,
    for the latency histograms): bucket deltas between the window's
    edge samples through the Prometheus interpolation rule
    (:func:`~.prom.quantile_from_parsed`). 0.0 for an empty window —
    same convention as an empty histogram."""
    parsed = _hist_delta_as_parsed(win, name)
    if parsed is None:
        return 0.0
    return prom.quantile_from_parsed(parsed, name, q)


def good_below(win: Sequence[Sample], name: str,
               bound: float) -> float:
    """How many of the window's histogram observations were <=
    ``bound`` — the latency-SLI numerator (obs/slo.py ``p95_ms``
    objectives). Exact at bucket bounds; linearly interpolated inside
    the bucket containing ``bound`` (the same assumption the quantile
    rule makes in the other direction). Observations beyond the last
    finite bucket count only if the bound is +inf."""
    d = delta(win, name)
    if not isinstance(d, dict) or d["count"] <= 0:
        return 0.0
    acc = 0.0
    prev_le = 0.0
    for le, c in d["buckets"]:
        if bound >= le:
            acc += c
        else:
            if bound > prev_le and le > prev_le:
                acc += c * (bound - prev_le) / (le - prev_le)
            return acc
        prev_le = le
    if bound == float("inf"):
        acc += d["inf"]
    return acc


# ---------------------------------------------------------------------------
# fleet rollup
# ---------------------------------------------------------------------------

def rollup(histories: dict[str, Sequence[Sample]], *,
           offsets: dict[str, float] | None = None,
           bin_s: float = 1.0) -> list[Sample]:
    """Merge per-replica histories into one fleet history.

    ``histories`` maps replica name -> its ``[(t, snapshot)]`` samples
    in the REPLICA's clock; ``offsets`` maps name -> clock offset
    (remote minus local) applied as ``t_local = t_remote - offset``.
    Corrected samples are binned on a ``bin_s`` grid; within one bin a
    replica contributes its NEWEST sample (two quick samples must not
    double its counters), and only bins covered by EVERY replica are
    merged (:func:`~.registry.merge_snapshots`) — a bin missing a
    replica would render as a fleet-wide counter dip. Returns merged
    ``(t, snapshot)`` pairs, ``t`` = the newest member stamp, oldest
    first."""
    if bin_s <= 0:
        raise ValueError(f"bin_s must be > 0, got {bin_s}")
    offsets = offsets or {}
    live = {n: h for n, h in histories.items() if h}
    if not live:
        return []
    # per replica: {bin index -> (corrected_t, snapshot)} keeping the
    # newest sample per bin
    binned: dict[str, dict[int, Sample]] = {}
    for name, hist in live.items():
        off = float(offsets.get(name, 0.0))
        per: dict[int, Sample] = {}
        for t, snap in hist:
            tc = float(t) - off
            b = int(tc // bin_s)
            cur = per.get(b)
            if cur is None or tc >= cur[0]:
                per[b] = (tc, snap)
        binned[name] = per
    common = set.intersection(*(set(p) for p in binned.values()))
    out: list[Sample] = []
    for b in sorted(common):
        members = [binned[name][b] for name in sorted(binned)]
        out.append((max(t for t, _ in members),
                    merge_snapshots(*(s for _, s in members))))
    return out


# ---------------------------------------------------------------------------
# the GET /stats/history payload shape
# ---------------------------------------------------------------------------

def to_payload(history: Iterable[Sample], **meta: Any) -> dict:
    """History -> the JSON shape ``GET /stats/history`` serves
    (samples as ``[t, snapshot]`` lists; ``meta`` keys ride the top
    level)."""
    return {"samples": [[t, snap] for t, snap in history], **meta}


def parse_payload(payload: dict) -> list[Sample]:
    """The inverse: payload -> ``[(t, snapshot)]`` (tuples restored,
    timestamps floated) — what an offline reader and a fleet rollup
    read."""
    return [(float(t), snap) for t, snap in payload.get("samples", ())]
