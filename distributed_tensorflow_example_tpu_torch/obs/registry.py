"""Metrics registry: process-local counters, gauges and histograms (a
copy of ``distributed_tensorflow_example_tpu/obs/registry.py``, which is
standard library only; the port keeps its own copy instead of importing
the JAX package).

- :class:`Counter` (monotonic), :class:`Gauge` (set/inc/dec), and
  :class:`Histogram` (fixed buckets, ``sum``/``count``): the three
  Prometheus-exposable primitives (``obs/prom.py`` renders a snapshot).
- **One lock, atomic snapshot**: every mutation and :meth:`Registry.
  snapshot` serialize on a single re-entrant lock, so a snapshot can
  never observe a torn multi-counter invariant (e.g. ``hits + misses ==
  admissions``); callers group related increments under
  :meth:`Registry.atomic`.
- **Near-zero disabled fast path**: a disabled registry's ``inc`` /
  ``set`` / ``observe`` return after one attribute check, so
  ``--metrics off`` costs one branch per site.
- **Mergeable**: snapshots of same-named metrics add
  (:func:`merge_snapshots`): counters and histogram buckets sum, gauges
  take the last writer. ``obs/timeseries.py`` rides this.

Naming: ``<subsystem>_<what>_<unit>``, counters end ``_total``,
histograms name their unit (``_seconds``). Namespaced registries also
feed a process-wide {name -> ever-touched} accumulator
(:func:`process_metric_names`), which survives the registries, so a
test can ask which registered metrics were never moved
(:meth:`Registry.lint_untouched` asks it of one registry).
"""

from __future__ import annotations

import bisect
import threading
import weakref
from typing import Any, Iterable

# every live registry, for process-wide introspection; weak so
# short-lived engines don't accumulate
_ALL_REGISTRIES: "weakref.WeakSet[Registry]" = weakref.WeakSet()
_ALL_LOCK = threading.Lock()

# durable name-level accumulator for the tier-1 dead-counter lint:
# registries die with their engines (weak refs above), but "was metric
# name X ever mutated anywhere in this process" must survive them.
# Only NAMESPACED registries contribute (the production serving/
# training registries carry one; throwaway unit-test registries don't,
# so probe metrics can't pollute the suite banner).
_METRIC_NAMES: dict[str, bool] = {}


def all_registries() -> list["Registry"]:
    """Every registry still alive in this process (creation order is
    not guaranteed — consumers aggregate, they don't index)."""
    with _ALL_LOCK:
        return list(_ALL_REGISTRIES)


def process_metric_names() -> dict[str, bool]:
    """{metric name -> ever mutated} across every namespaced registry
    this process created, INCLUDING ones already garbage-collected —
    the tier-1 telemetry banner's data source."""
    with _ALL_LOCK:
        return dict(_METRIC_NAMES)


# latency-shaped default: 1ms .. 60s, roughly log-spaced. Fixed at
# registration time — merging requires identical buckets, so the
# default is deliberately one-size-fits-serving-and-training.
# Buckets are CONFIGURABLE per histogram at registration
# (``registry.histogram(name, buckets=...)``); same-named histograms
# across replicas must register identical bounds or the fleet
# ``/metrics`` merge refuses loudly (merge_snapshots).
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

# request-phase serving buckets, audited against measured serving
# latencies: queue waits and prefix-cache mounts land at
# tens-to-hundreds of µs on CPU — entirely inside DEFAULT_BUCKETS'
# first (1 ms) bucket, where every percentile query degenerates to
# "≤1ms" — so sub-millisecond bounds are added below; the 60 s top
# bound stays (nothing measured approaches it, and the load harness's
# saturation check now pins that no default-registered histogram
# overflows its top finite bucket at p99).
SERVING_LATENCY_BUCKETS = (0.0001, 0.00025, 0.0005) + DEFAULT_BUCKETS


class _NoopCM:
    """Shared do-nothing context manager for disabled-registry
    ``atomic()`` groups."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_CM = _NoopCM()


class _Metric:
    """Shared base: name/help/touched bookkeeping. ``touched`` flips on
    the first mutation ever (even one that lands value 0) — the
    dead-counter lint's signal, distinct from "value is still 0"."""

    __slots__ = ("name", "help", "_reg", "touched")

    def __init__(self, reg: "Registry", name: str, help: str):
        self._reg = reg
        self.name = name
        self.help = help
        self.touched = False

    def _mark_touched(self) -> None:
        """First mutation only (callers guard on ``touched``): flips
        the instance flag and, for namespaced registries, the durable
        process-wide name accumulator the tier-1 lint reads."""
        self.touched = True
        if self._reg.namespace:
            _METRIC_NAMES[self.name] = True


class Counter(_Metric):
    """Monotonic counter. ``inc`` of a negative amount is a bug and
    raises (a counter that can go down is a gauge)."""

    __slots__ = ("_value",)

    def __init__(self, reg, name, help):
        super().__init__(reg, name, help)
        self._value = 0

    def inc(self, n: int | float = 1) -> None:
        reg = self._reg
        if not reg.enabled:
            return
        if n < 0:
            raise ValueError(f"counter {self.name} inc({n}): counters "
                             "are monotonic — use a Gauge")
        with reg._lock:
            self._value += n
            if not self.touched:
                self._mark_touched()

    @property
    def value(self):
        with self._reg._lock:
            return self._value


class Gauge(_Metric):
    """Last-write-wins scalar (queue depth, live slots, free blocks)."""

    __slots__ = ("_value",)

    def __init__(self, reg, name, help):
        super().__init__(reg, name, help)
        self._value = 0

    def set(self, v: int | float) -> None:
        reg = self._reg
        if not reg.enabled:
            return
        with reg._lock:
            self._value = v
            if not self.touched:
                self._mark_touched()

    def inc(self, n: int | float = 1) -> None:
        reg = self._reg
        if not reg.enabled:
            return
        with reg._lock:
            self._value += n
            if not self.touched:
                self._mark_touched()

    def dec(self, n: int | float = 1) -> None:
        self.inc(-n)

    @property
    def value(self):
        with self._reg._lock:
            return self._value


class Histogram(_Metric):
    """Fixed-bucket histogram: cumulative bucket counts (Prometheus
    ``le`` semantics) + ``sum`` + ``count``. Buckets are immutable
    after registration — that is what makes two snapshots mergeable."""

    __slots__ = ("buckets", "_counts", "_sum", "_count")

    def __init__(self, reg, name, help, buckets: Iterable[float]):
        super().__init__(reg, name, help)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError(f"histogram {self.name}: needs >= 1 bucket")
        self.buckets = bs
        self._counts = [0] * (len(bs) + 1)    # +1 = the +Inf bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        reg = self._reg
        if not reg.enabled:
            return
        with reg._lock:
            self._counts[bisect.bisect_left(self.buckets, v)] += 1
            self._sum += v
            self._count += 1
            if not self.touched:
                self._mark_touched()

    @property
    def count(self) -> int:
        with self._reg._lock:
            return self._count


class Registry:
    """One namespace of metrics; all mutation and snapshotting
    serialize on ``_lock`` (re-entrant, so grouped updates under
    :meth:`atomic` can still call ``inc`` per metric)."""

    def __init__(self, *, enabled: bool = True, namespace: str = ""):
        self.enabled = enabled
        self.namespace = namespace
        self._lock = threading.RLock()
        self._metrics: dict[str, _Metric] = {}
        with _ALL_LOCK:
            _ALL_REGISTRIES.add(self)

    # -- registration --------------------------------------------------
    def _register(self, cls, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(m).__name__}, not {cls.__name__}")
                return m
            m = cls(self, name, help, **kw)
            self._metrics[name] = m
            if self.namespace:
                _METRIC_NAMES.setdefault(name, False)
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, buckets=buckets)

    # -- atomicity -----------------------------------------------------
    def atomic(self):
        """Hold the registry lock across several mutations so a
        concurrent :meth:`snapshot` sees all or none of them::

            with reg.atomic():
                admissions.inc()
                misses.inc()

        Disabled registry: a shared no-op context manager — grouped
        sites keep the one-branch-per-site cost the disabled fast
        path promises (the inner ``inc`` calls are no-ops anyway)."""
        return self._lock if self.enabled else _NOOP_CM

    # -- reading -------------------------------------------------------
    def snapshot(self) -> dict[str, dict[str, Any]]:
        """One atomic copy of every metric: ``{name: {"type": ...,
        "value"| "buckets"/"sum"/"count", "help"}}`` — plain data, safe
        to hand across threads / serialize."""
        with self._lock:
            out: dict[str, dict[str, Any]] = {}
            for name, m in self._metrics.items():
                if isinstance(m, Counter):
                    out[name] = {"type": "counter", "value": m._value,
                                 "help": m.help}
                elif isinstance(m, Gauge):
                    out[name] = {"type": "gauge", "value": m._value,
                                 "help": m.help}
                else:
                    h: Histogram = m            # type: ignore[assignment]
                    out[name] = {"type": "histogram",
                                 "buckets": list(zip(h.buckets,
                                                     h._counts[:-1])),
                                 "inf": h._counts[-1],
                                 "sum": h._sum, "count": h._count,
                                 "help": m.help}
            return out

    def lint_untouched(self) -> list[str]:
        """Names of metrics registered but NEVER mutated — the
        dead-counter signal the tier-1 telemetry banner prints. A
        counter that was inc'd to its current value of 0 does not
        count as dead (``touched`` tracks mutation, not value)."""
        with self._lock:
            return sorted(n for n, m in self._metrics.items()
                          if not m.touched)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)


def merge_snapshots(*snaps: dict[str, dict[str, Any]]
                    ) -> dict[str, dict[str, Any]]:
    """Combine snapshots (e.g. engine + batcher + trainer registries
    into one /metrics page): counters and histogram buckets/sum/count
    ADD; gauges take the later snapshot's value; a type conflict for a
    shared name is a loud error, never a silent overwrite."""
    out: dict[str, dict[str, Any]] = {}
    for snap in snaps:
        for name, rec in snap.items():
            cur = out.get(name)
            if cur is None:
                out[name] = {k: (list(v) if isinstance(v, list) else v)
                             for k, v in rec.items()}
                continue
            if cur["type"] != rec["type"]:
                raise ValueError(
                    f"metric {name!r}: cannot merge {cur['type']} with "
                    f"{rec['type']}")
            if cur["type"] == "counter":
                cur["value"] += rec["value"]
            elif cur["type"] == "gauge":
                cur["value"] = rec["value"]
            else:
                if [b for b, _ in cur["buckets"]] != \
                        [b for b, _ in rec["buckets"]]:
                    raise ValueError(
                        f"histogram {name!r}: bucket bounds differ — "
                        "snapshots are only mergeable with identical "
                        "buckets")
                cur["buckets"] = [(b, c1 + c2) for (b, c1), (_, c2)
                                  in zip(cur["buckets"], rec["buckets"])]
                cur["inf"] += rec["inf"]
                cur["sum"] += rec["sum"]
                cur["count"] += rec["count"]
    return out
