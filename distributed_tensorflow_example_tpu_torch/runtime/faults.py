"""Deterministic fault injection at the generation engine's seams (an
adapted copy of the serving part of
``distributed_tensorflow_example_tpu/runtime/faults.py``; the training
and fleet seams arrive with their slices).

Spec grammar (``;``-separated rules, ``:``-separated fields)::

    site[:key=value]*

    engine.decode_step:step=3            # 3rd shared decode dispatch
    engine.decode_step:p=0.05            # flaky decode dispatches
    engine.prefill:step=2                # 2nd prefill dispatch raises
    engine.admit:step=1                  # 1st admission fails
    pool.alloc:p=0.01                    # block allocator hiccups

Fields: ``step=N`` fires on the site's Nth invocation (1-based) and is
one-shot. ``p=F`` fires each invocation with probability F from a stream
seeded on (seed, site, invocation, attempt) — deterministic across
reruns. ``raise=NAME`` picks the exception (OSError default;
IOError/ValueError/RuntimeError allowed).

Inert by default: every seam calls :func:`inject`, a single ``is None``
check when no registry is installed.
"""

from __future__ import annotations

import threading
import zlib
from dataclasses import dataclass

import numpy as np

from ..utils.logging import get_logger

log = get_logger("faults")

#: the engine's injection points; inject() on anything else is a bug
SITES = ("engine.prefill", "engine.decode_step", "engine.admit",
         "pool.alloc")

#: exceptions a rule may raise — an allowlist so a typo'd spec fails at
#: parse time, not as a silent never-firing rule
EXCEPTIONS = {"OSError": OSError, "IOError": IOError,
              "ValueError": ValueError, "RuntimeError": RuntimeError}


class FaultSpecError(ValueError):
    """A fault spec string the grammar cannot honor (a silently ignored
    rule would fake chaos coverage)."""


@dataclass
class FaultRule:
    site: str
    step: int | None = None        # fire on the site's Nth invocation
    p: float | None = None         # else: per-invocation probability
    exc: str = "OSError"
    fired: int = 0                 # one-shot bookkeeping for step= rules

    def describe(self) -> str:
        parts = [self.site]
        if self.step is not None:
            parts.append(f"step={self.step}")
        if self.p is not None:
            parts.append(f"p={self.p}")
        parts.append(f"raise={self.exc}")
        return ":".join(parts)


def parse_spec(spec: str, *, seed: int = 0) -> "FaultRegistry":
    """Parse a fault spec string into a registry. Raises
    :class:`FaultSpecError` on anything the grammar cannot honor."""
    rules: list[FaultRule] = []
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        parts = raw.split(":")
        site = parts[0].strip()
        if site not in SITES:
            raise FaultSpecError(
                f"unknown fault site {site!r} in {raw!r}: sites are "
                f"{', '.join(SITES)}")
        rule = FaultRule(site=site)
        for kv in parts[1:]:
            if "=" not in kv:
                raise FaultSpecError(
                    f"malformed field {kv!r} in rule {raw!r} (want "
                    "key=value)")
            k, v = (s.strip() for s in kv.split("=", 1))
            if k == "step":
                rule.step = int(v)
                if rule.step < 1:
                    raise FaultSpecError(
                        f"step={v} in {raw!r}: invocation indices are "
                        "1-based")
            elif k == "p":
                rule.p = float(v)
                if not 0.0 < rule.p <= 1.0:
                    raise FaultSpecError(
                        f"p={v} in {raw!r} must be in (0, 1]")
            elif k == "raise":
                if v not in EXCEPTIONS:
                    raise FaultSpecError(
                        f"raise={v!r} in {raw!r}: allowed are "
                        f"{', '.join(EXCEPTIONS)}")
                rule.exc = v
            else:
                raise FaultSpecError(
                    f"unknown field {k!r} in rule {raw!r}")
        if (rule.step is None) == (rule.p is None):
            raise FaultSpecError(
                f"rule {raw!r} needs exactly one trigger: step=N or p=F")
        rules.append(rule)
    if not rules:
        raise FaultSpecError(f"fault spec {spec!r} contains no rules")
    return FaultRegistry(rules, seed=seed)


class FaultRegistry:
    """Seeded fault plan. Thread-safe: seams fire from the scheduler
    thread, the spec is installed from another."""

    def __init__(self, rules: list[FaultRule], *, seed: int = 0):
        self.rules = rules
        self.seed = seed
        self._counts: dict[str, int] = {}
        self._lock = threading.Lock()
        self.fired: list[str] = []       # human-readable audit trail

    def _bernoulli(self, site: str, count: int, p: float,
                   attempt: int) -> bool:
        # keyed on (seed, site, invocation, retry attempt): deterministic
        # across reruns, independent across invocations and across the
        # retry probes of one invocation
        rng = np.random.default_rng(
            (self.seed, zlib.crc32(site.encode()), count, attempt))
        return bool(rng.random() < p)

    def _match(self, site: str, count: int,
               attempt: int) -> FaultRule | None:
        for rule in self.rules:
            if rule.site != site:
                continue
            if rule.step is not None:
                if rule.fired or count != rule.step:
                    continue
            elif not self._bernoulli(site, count, rule.p, attempt):
                continue
            rule.fired += 1
            self.fired.append(f"{rule.describe()}@{count}")
            return rule
        return None

    def next_index(self, site: str) -> int:
        """Advance and return the site's invocation counter. A retried
        invocation re-probes the SAME index, so retries do not shift
        later ``step=N`` rules."""
        with self._lock:
            index = self._counts.get(site, 0) + 1
            self._counts[site] = index
            return index

    def check(self, site: str, index: int | None = None,
              attempt: int = 0) -> FaultRule | None:
        """Probe the site at ``index`` (default: advance the counter) and
        return the rule that fires, if any."""
        if site not in SITES:
            raise ValueError(f"unregistered fault site {site!r}")
        if index is None:
            index = self.next_index(site)
        with self._lock:
            return self._match(site, index, attempt)

    def raise_if_armed(self, site: str, index: int | None = None,
                       detail: str = "", attempt: int = 0) -> None:
        rule = self.check(site, index, attempt)
        if rule is None:
            return
        log.warning("fault injected: %s %s", rule.describe(), detail)
        raise EXCEPTIONS[rule.exc](
            f"injected fault {rule.describe()} {detail}".strip())


_REGISTRY: FaultRegistry | None = None


def install(registry: FaultRegistry | None) -> None:
    """Install (or, with None, clear) the process-global registry."""
    global _REGISTRY
    _REGISTRY = registry
    if registry is not None:
        log.warning("fault injection ACTIVE: %s",
                    "; ".join(r.describe() for r in registry.rules))


def active() -> FaultRegistry | None:
    return _REGISTRY


def inject(site: str, index: int | None = None, detail: str = "") -> None:
    """The seam call: no-op (one None check) unless a registry is
    installed."""
    reg = _REGISTRY
    if reg is None:
        return
    reg.raise_if_armed(site, index, detail)
