"""Metrics registry: process-local counters, gauges and histograms (an
adapted copy of ``distributed_tensorflow_example_tpu/obs/registry.py``,
which is standard library only; the port keeps its own copy instead of
importing the JAX package, with the parts the engine and ``/stats`` read).

- :class:`Counter` (monotonic), :class:`Gauge` (set/inc/dec), and
  :class:`Histogram` (fixed buckets, ``sum``/``count``).
- **One lock, atomic snapshot**: every mutation and :meth:`Registry.
  snapshot` serialize on a single re-entrant lock, so a snapshot can
  never observe a torn multi-counter invariant (e.g. ``hits + misses ==
  admissions``); callers group related increments under
  :meth:`Registry.atomic`.
- **Near-zero disabled fast path**: a disabled registry's ``inc`` /
  ``set`` / ``observe`` return after one attribute check.

Naming: ``<subsystem>_<what>_<unit>``, counters end ``_total``,
histograms name their unit (``_seconds``).
"""

from __future__ import annotations

import bisect
import threading
from typing import Any, Iterable

# latency-shaped default: 1ms .. 60s, roughly log-spaced, fixed at
# registration time
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

# request-phase serving buckets: queue waits and prefix-cache mounts land
# far below 1 ms, so sub-millisecond bounds come first
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
    __slots__ = ("name", "help", "_reg")

    def __init__(self, reg: "Registry", name: str, help: str):
        self._reg = reg
        self.name = name
        self.help = help


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

    def inc(self, n: int | float = 1) -> None:
        reg = self._reg
        if not reg.enabled:
            return
        with reg._lock:
            self._value += n

    def dec(self, n: int | float = 1) -> None:
        self.inc(-n)

    @property
    def value(self):
        with self._reg._lock:
            return self._value


class Histogram(_Metric):
    """Fixed-bucket histogram: cumulative bucket counts (Prometheus
    ``le`` semantics) + ``sum`` + ``count``."""

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
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, buckets=buckets)

    def atomic(self):
        """Hold the registry lock across several mutations so a
        concurrent :meth:`snapshot` sees all or none of them. Disabled
        registry: a shared no-op context manager."""
        return self._lock if self.enabled else _NOOP_CM

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

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)
