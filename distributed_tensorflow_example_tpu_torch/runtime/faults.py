"""Deterministic fault injection at the training and generation-engine
HTTP and fleet seams (an adapted copy of
``distributed_tensorflow_example_tpu/runtime/faults.py``).

Spec grammar (``;``-separated rules, ``:``-separated fields)::

    site[:key=value]*

    ckpt.write:step=2:raise=OSError      # 2nd checkpoint write raises
    ckpt.write:step=3:corrupt=truncate   # 3rd write lands torn on disk
    ckpt.read:p=0.5                      # half of reads raise OSError
    loader.next:p=0.01                   # 1% of batch fetches raise
    loader.next:step=5:raise=IOError     # exactly the 5th fetch
    step.nan:step=7                      # global step 7's batch -> NaN
    step.inf:step=9:proc=0               # only on rank 0
    engine.decode_step:step=3            # 3rd shared decode dispatch
    engine.decode_step:p=0.05            # flaky decode dispatches
    engine.prefill:step=2                # 2nd prefill dispatch raises
    engine.admit:step=1                  # 1st admission fails
    pool.alloc:p=0.01                    # block allocator hiccups
    http.read:step=1                     # 1st request body read fails
    engine.decode_step:step=4:stall=3    # 4th decode dispatch wedges 3 s
    router.probe:step=2                  # 2nd fleet health probe fails
    router.forward:step=3                # 3rd forwarded request drops
    replica.crash:step=3                 # 3rd forward KILLS its target

The ``router.*``/``replica.*`` sites are the fleet seams:
``router.probe`` fails a health probe, ``router.forward`` drops a
forwarded request on the network floor, and ``replica.crash`` is the kill
switch (the router's forward path hard-kills the targeted in-process
replica and surfaces a connection error; ``experiments/fleet_chaos.py``
drills it).

Fields: ``step=N`` fires on the site's Nth invocation (1-based; for the
``step.*`` sites the invocation index is the global training step) and is
one-shot, so a rolled-back replay does not trip it again. ``p=F`` fires
each invocation with probability F from a stream seeded on (seed, site,
invocation, attempt) — deterministic across reruns. ``raise=NAME`` picks
the exception (OSError default; IOError/ValueError/RuntimeError allowed).
``corrupt=truncate|zero`` (``ckpt.write`` only) lets the write succeed,
then damages the committed file. ``stall=S`` (a port addition) raises
nothing: the seam's thread sleeps S seconds and proceeds, a wedged call
(the scheduler's watchdog sees it as a stall). ``proc=K`` restricts a
rule to rank K.

Inert by default: every seam calls :func:`inject` (or wraps through
:func:`guard_iterator`), a single ``is None`` check when no registry is
installed.
"""

from __future__ import annotations

import threading
import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Iterator

import numpy as np

from ..utils.logging import get_logger
from . import distributed

log = get_logger("faults")

#: the injection points; inject() on anything else is a bug
SITES = ("ckpt.write", "ckpt.commit", "ckpt.read", "loader.next",
         "step.nan", "step.inf",
         "engine.prefill", "engine.decode_step", "engine.admit",
         "pool.alloc", "http.read",
         "router.probe", "router.forward", "replica.crash")

#: exceptions a rule may raise — an allowlist so a typo'd spec fails at
#: parse time, not as a silent never-firing rule
EXCEPTIONS = {"OSError": OSError, "IOError": IOError,
              "ValueError": ValueError, "RuntimeError": RuntimeError}

CORRUPT_MODES = ("truncate", "zero")


class FaultSpecError(ValueError):
    """A fault spec string the grammar cannot honor (a silently ignored
    rule would fake chaos coverage)."""


@dataclass
class FaultRule:
    site: str
    step: int | None = None        # fire on the site's Nth invocation
    p: float | None = None         # else: per-invocation probability
    exc: str = "OSError"
    corrupt: str | None = None     # ckpt.write: damage the landed file
    stall: float | None = None     # sleep this long instead of raising
    proc: int | None = None        # restrict to one rank
    fired: int = 0                 # one-shot bookkeeping for step= rules

    def describe(self) -> str:
        parts = [self.site]
        if self.step is not None:
            parts.append(f"step={self.step}")
        if self.p is not None:
            parts.append(f"p={self.p}")
        if self.corrupt:
            parts.append(f"corrupt={self.corrupt}")
        elif self.stall:
            parts.append(f"stall={self.stall:g}")
        else:
            parts.append(f"raise={self.exc}")
        if self.proc is not None:
            parts.append(f"proc={self.proc}")
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
            elif k == "corrupt":
                if v not in CORRUPT_MODES:
                    raise FaultSpecError(
                        f"corrupt={v!r} in {raw!r}: modes are "
                        f"{', '.join(CORRUPT_MODES)}")
                rule.corrupt = v
            elif k == "stall":
                rule.stall = float(v)
                if not rule.stall > 0.0:
                    raise FaultSpecError(
                        f"stall={v} in {raw!r} must be > 0 seconds")
            elif k == "proc":
                rule.proc = int(v)
            else:
                raise FaultSpecError(
                    f"unknown field {k!r} in rule {raw!r}")
        if (rule.step is None) == (rule.p is None):
            raise FaultSpecError(
                f"rule {raw!r} needs exactly one trigger: step=N or p=F")
        if rule.corrupt and rule.stall:
            raise FaultSpecError(
                f"rule {raw!r} sets both corrupt= and stall=")
        if rule.corrupt and rule.site != "ckpt.write":
            raise FaultSpecError(
                f"corrupt= only applies to ckpt.write (got {raw!r}): only "
                "a write can land torn bytes")
        rules.append(rule)
    if not rules:
        raise FaultSpecError(f"fault spec {spec!r} contains no rules")
    return FaultRegistry(rules, seed=seed)


class FaultRegistry:
    """Seeded, rank-aware fault plan. Thread-safe: checkpoint writes fire
    from the async writer thread, loader faults from the prefetch thread,
    engine faults from the scheduler thread."""

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
            if (rule.proc is not None
                    and rule.proc != distributed.process_index()):
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
        """Probe the site at ``index`` (default: advance the counter; the
        train step passes its global step instead) and return the rule
        that fires, if any."""
        if site not in SITES:
            raise ValueError(f"unregistered fault site {site!r}")
        if index is None:
            index = self.next_index(site)
        with self._lock:
            return self._match(site, index, attempt)

    def raise_if_armed(self, site: str, index: int | None = None,
                       detail: str = "", attempt: int = 0
                       ) -> FaultRule | None:
        """Raise the fired rule's exception; a ``corrupt=`` rule is
        returned instead, for the caller to apply after its write, and a
        ``stall=`` rule sleeps on the calling thread and returns None."""
        rule = self.check(site, index, attempt)
        if rule is None:
            return None
        if rule.corrupt:
            return rule
        if rule.stall:
            log.warning("fault injected: %s %s (stalling %.3gs)",
                        rule.describe(), detail, rule.stall)
            time.sleep(rule.stall)
            return None
        log.warning("fault injected: %s %s", rule.describe(), detail)
        raise EXCEPTIONS[rule.exc](
            f"injected fault {rule.describe()} {detail}".strip())

    def poison_batch(self, batch: dict, step: int) -> dict:
        """Host-side NaN/Inf poisoning of the batch that produces global
        step ``step`` (the ``step.*`` sites): the first floating-point
        leaf, in key order, is multiplied by the value. The step program
        is untouched; the data is what is broken."""
        value = None
        if self.check("step.nan", index=step) is not None:
            value = np.nan
        if self.check("step.inf", index=step) is not None:
            value = np.inf
        if value is None:
            return batch
        out = dict(batch)
        for k in sorted(out):
            arr = np.asarray(out[k])
            if np.issubdtype(arr.dtype, np.floating):
                log.warning("fault injected: step %d batch key %r "
                            "poisoned with %s", step, k, value)
                out[k] = arr * value
                return out
        # integer-only batches (token ids): no data value reliably gives
        # a non-finite loss, and a silently inert rule would fake chaos
        # coverage
        raise FaultSpecError(
            f"step.{'nan' if np.isnan(value) else 'inf'} fired at step "
            f"{step} but the batch has no floating-point leaf to poison "
            f"(keys: {sorted(out)}); integer token batches cannot be "
            "data-poisoned into a non-finite loss — target a float-input "
            "model for this fault site")


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


def inject(site: str, index: int | None = None, detail: str = ""
           ) -> FaultRule | None:
    """The seam call: no-op (one None check) unless a registry is
    installed. Returns the fired rule only for ``corrupt=`` rules, whose
    damage the call site applies after its write lands."""
    reg = _REGISTRY
    if reg is None:
        return None
    return reg.raise_if_armed(site, index, detail)


#: bounded-retry defaults for transient IO: 3 retries, 50 ms doubling
RETRY_ATTEMPTS = 4
RETRY_BASE_DELAY = 0.05

#: exception types treated as transient (retryable) on IO paths
TRANSIENT_IO = (OSError,)


def retry_io(fn: Callable[[], Any], *, what: str) -> Any:
    """Run ``fn`` with bounded retry and exponential backoff on transient
    IO errors (:data:`TRANSIENT_IO`); the last failure propagates. The
    policy is the module constants, read at call time."""
    delay = RETRY_BASE_DELAY
    for attempt in range(1, RETRY_ATTEMPTS + 1):
        try:
            return fn()
        except TRANSIENT_IO as e:
            if attempt >= RETRY_ATTEMPTS:
                raise
            log.warning("%s failed (attempt %d/%d): %s — retrying in "
                        "%.2fs", what, attempt, RETRY_ATTEMPTS, e, delay)
            time.sleep(delay)
            delay *= 2


_LOADER_SITE = "loader.next"


@dataclass
class _GuardedIterator:
    """Iterator wrapper placing the ``loader.next`` injection point (with
    the :func:`retry_io` policy) BEFORE the underlying iterator is
    touched: a raised injection must never kill the source generator, or
    the retry would resume a dead stream."""

    it: Iterator

    def __iter__(self):
        return self

    def __next__(self):
        reg = _REGISTRY
        if reg is not None:
            # one invocation index per fetch: retries re-probe it (step
            # rules are spent after firing; p-rules resample per attempt)
            idx = reg.next_index(_LOADER_SITE)
            attempt = [0]

            def probe():
                a, attempt[0] = attempt[0], attempt[0] + 1
                reg.raise_if_armed(_LOADER_SITE, index=idx, attempt=a)

            retry_io(probe, what=_LOADER_SITE)
        return next(self.it)

    def close(self) -> None:
        close = getattr(self.it, "close", None)
        if close is not None:
            close()


def guard_iterator(it: Iterator) -> Iterator:
    """Wrap a batch iterator with the ``loader.next`` injection and retry
    guard; the iterator itself when no registry is installed."""
    if _REGISTRY is None:
        return it
    return _GuardedIterator(it)
