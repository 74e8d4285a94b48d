"""Continuous-batching generation scheduler (an adapted copy of
``distributed_tensorflow_example_tpu/serving_batch.py``, kept close to it
line for line so that the two can be diffed).

:class:`GenerationEngine` is a scheduler thread owning the cache pool of a
stepwise export (``serving.StepwiseGenerator``). Queued requests are
admitted into free slots at step boundaries (one prefill call each —
prefill joins mid-flight), every iteration runs ONE shared decode step for
all live slots, and per-request sampling (greedy / temperature / top-k /
top-p with a per-request seed) happens on the host side of the step
boundary. A request retires on its own EOS / ``max_new`` without
disturbing its neighbors.

With a PAGED export the engine swaps the ``slots x T`` slab reservation
for a shared pool of ``block_size``-token physical blocks plus per-slot
block tables (:class:`BlockPool`: refcounted, allocate-on-write during
decode, retirement returns blocks, block 0 reserved as the never-read null
target). Admission consults a :class:`PrefixCache` (token-prefix hash at
block granularity, LRU): a hit mounts the cached blocks by reference and
teacher-forces only the uncached suffix through the SHARED decode step —
zero prefill dispatches for a repeated prefix — and a write into a
still-shared block copies it first (copy-on-write), so divergence can
never corrupt a neighbor or the cache. Admission and 429 are driven by
BLOCK exhaustion, not slot count.

Self-healing as in the reference: deadlines and cancellation between
steps, poison-request quarantine (a failed admission fails only its
request; a shared decode failure is retried once, then the newest slot is
evicted), a watchdog heartbeat, graceful drain, priority admission and
the brownout shedding ladder. A full queue raises :class:`QueueFullError`
(HTTP 429 + a measured ``Retry-After``).

Speculative decoding (``spec_tokens=K`` over an export with the verify
step): each live greedy slot drafts with a host-side
:class:`NgramDrafter` (prompt lookup over its own context), and a shared
step where any slot drafted dispatches the K-token verify step instead of
the single-token one; draftless rows ride it at width 1. The exact greedy
rejection rule keeps greedy output equal to spec-off decoding; a
rejection rewinds the slot's ``pos``. Chunked prefill
(``prefill_chunk_tokens=C`` over an export with the chunked prefill): a
cold admission parks its slot and the scheduler feeds one block-aligned
chunk a loop iteration, between shared decode steps, so a long prompt
stalls live decoders for one chunk at a time (the
``serving_decode_stall_seconds`` histogram).

What differs from the reference: the port's pools are torch tensors that
the stepwise calls (the verify and chunk steps included) update in place
on the device, so copy-on-write is an in-place block copy and no call
consumes the pool: ``_pool_alive`` stays true, and every failed dispatch
takes the quarantine path.

:class:`MicroBatcher` is the ``:predict`` path: dynamic micro-batching of
forward rows into power-of-two buckets over one ``serving.ServableModel``
of a forward export.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
from collections import OrderedDict, deque
# the stdlib Future is the right primitive (set_result/set_exception/
# result(timeout)); NOTE concurrent.futures.TimeoutError only became
# the builtin TimeoutError alias in 3.11 — on 3.10 they are distinct
# classes, so timeout handling must catch BOTH. The repo already leans
# on concurrent.futures elsewhere (async ckpt writer, streaming decode
# pool)
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutureTimeout

import uuid

import numpy as np

from .obs.registry import SERVING_LATENCY_BUCKETS, Registry
from .obs.trace import add_span, span
from .runtime import faults
from .serving import ServableModel, StepwiseGenerator, storage_dtype
from .utils.logging import get_logger

log = get_logger("serving")


def _itemsize(dtype_name: str) -> int:
    """Bytes per element of a pool dtype named in ``export.json``
    (``bfloat16`` is a torch dtype, not a numpy one; ``int8`` is 1)."""
    return storage_dtype(dtype_name).itemsize


class QueueFullError(Exception):
    """Admission queue at capacity — the caller should retry later
    (HTTP maps this to 429 + Retry-After seconds)."""

    def __init__(self, msg: str, retry_after: float = 1.0):
        super().__init__(msg)
        self.retry_after = retry_after


class ShedError(QueueFullError):
    """This request was SHED by the overload-resilience machinery —
    brownout class shedding (the pressure ladder refuses its priority
    class) or feasibility shedding (its ``deadline_ms`` is already
    unmeetable at the measured service rate). A
    :class:`QueueFullError` subclass so every existing 429 +
    ``Retry-After`` mapping (HTTP layer, router pushback) applies
    unchanged; the Retry-After is the measured estimate, never a
    guess, and shedding NOW beats expiring into a 504 after wasting
    queue time."""


class DrainingError(Exception):
    """The engine is draining (graceful shutdown): no new admissions.
    HTTP maps this to 503 + Retry-After — the client should retry
    against another replica (or the same one after it restarts)."""

    def __init__(self, msg: str, retry_after: float = 1.0):
        super().__init__(msg)
        self.retry_after = retry_after


class BlocksExhaustedError(Exception):
    """The paged cache pool has no free physical block left (even after
    prefix-cache eviction). The one request that needed the block fails
    loudly; the engine keeps serving its neighbors."""


class RequestCancelledError(Exception):
    """This request was cancelled (``POST /cancel/<request_id>``, an
    :class:`EngineHandle` timeout, or ``handle.cancel()``) — its slot
    and cache blocks were released the moment the scheduler saw the
    cancellation."""


class DeadlineExceededError(TimeoutError):
    """The request's ``deadline_ms`` budget expired before it finished;
    the scheduler retired it between steps (HTTP: 504). A
    ``TimeoutError`` subclass so generic timeout handling still
    applies."""


class PoisonedRequestError(RuntimeError):
    """This request was failed by the engine's quarantine protocol: its
    own admission/prefill dispatch raised, or it was the newest-admitted
    slot when a shared decode step failed twice in a row. Its neighbors
    kept decoding (HTTP: 500 for THIS request only)."""


class EngineStalledError(RuntimeError):
    """The scheduler thread failed to park within the close/drain
    budget — the hung-thread condition ``join(timeout)`` used to
    swallow silently. Carries the last-heartbeat age so the operator
    sees HOW wedged the thread is."""


# ---------------------------------------------------------------------------
# thread-ownership discipline: markers + debug sanitizer (round 13)
#
# The engine's correctness rests on ONE invariant no test used to pin
# directly: the scheduler thread alone touches the pool, the live-slot
# map, the block allocator, and the prefix cache. The markers below
# DECLARE that ownership so tools/graftlint's THR01 rule can check it
# statically (a method referencing an owned field must be
# @scheduler_thread, or @snapshot_view and read-only), and the optional
# runtime sanitizer enforces it on every attribute access in debug runs.
# ---------------------------------------------------------------------------

class ThreadOwnershipError(AssertionError):
    """A scheduler-owned field was touched from a foreign thread — the
    exact race class the single-flight scheduler design exists to make
    impossible. Raised only under ``thread_sanitizer=True``."""


def scheduler_owned(*fields: str):
    """Class decorator declaring which fields ONLY the scheduler thread
    may touch (cross-thread readers go through the snapshot views).
    Pure metadata at runtime until ``thread_sanitizer=True`` swaps the
    instance onto a subclass with guarded descriptors."""
    def deco(cls):
        cls.__scheduler_owned__ = tuple(fields)
        return cls
    return deco


def scheduler_thread(fn):
    """Marks a method as running on the engine's scheduler thread (full
    access to ``@scheduler_owned`` fields). Metadata for graftlint's
    THR01 rule — no runtime behavior."""
    fn.__scheduler_thread__ = True
    return fn


def snapshot_view(fn):
    """Marks a method as a cross-thread SNAPSHOT VIEW: it may READ
    scheduler-owned fields (never write). The wrapper holds the
    instance's view context manager for the call — a no-op object when
    the sanitizer is off, the thread-local read allowance when armed —
    so the method body itself stays sanitizer-unaware."""
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._san_view_cm:
            return fn(self, *args, **kwargs)
    wrapper.__snapshot_view__ = True
    return wrapper


_SAN_TL = threading.local()


class _SnapshotReads:
    """Context manager a @snapshot_view method holds while reading
    owned fields: flips the thread-local read allowance the guarded
    descriptors honor (re-entrant via a depth counter)."""

    __slots__ = ()

    def __enter__(self):
        _SAN_TL.allow_reads = getattr(_SAN_TL, "allow_reads", 0) + 1
        return self

    def __exit__(self, *exc):
        _SAN_TL.allow_reads -= 1
        return False


class _NoopCM:
    """The disabled path's stand-in — one branchless no-op per view,
    mirroring the obs.registry disabled-registry pattern."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_SNAPSHOT_READS = _SnapshotReads()
_NOOP_CM = _NoopCM()


class _GuardedAttr:
    """Data descriptor standing in for one scheduler-owned field when
    the sanitizer is armed: every read/write asserts the caller IS the
    scheduler thread (or, for reads, inside a snapshot view). The value
    itself lives in the instance ``__dict__`` as before."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def _check(self, obj, mode: str) -> None:
        tid = obj.__dict__.get("_san_tid")
        if tid is None or threading.get_ident() == tid:
            return
        if mode == "read" and getattr(_SAN_TL, "allow_reads", 0):
            return
        raise ThreadOwnershipError(
            f"scheduler-owned field `{type(obj).__name__}.{self.name}` "
            f"{mode} from thread {threading.current_thread().name!r} "
            f"(ident {threading.get_ident()}); only the scheduler "
            f"thread (ident {tid}) owns it — cross-thread readers go "
            "through the snapshot views (stats/metrics_snapshot)")

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        self._check(obj, "read")
        try:
            return obj.__dict__[self.name]
        except KeyError:
            raise AttributeError(self.name) from None

    def __set__(self, obj, value):
        self._check(obj, "write")
        obj.__dict__[self.name] = value

    def __delete__(self, obj):
        self._check(obj, "write")
        del obj.__dict__[self.name]


_SANITIZED_CLASSES: dict[type, type] = {}


def _sanitized_class(cls: type) -> type:
    """Per-base-class cached subclass with a :class:`_GuardedAttr` per
    ``@scheduler_owned`` field. Instances opt in by swapping their
    ``__class__`` — so with the sanitizer OFF the engine keeps its
    plain class and plain attributes: zero overhead, not even a branch,
    on the hot decode path."""
    sub = _SANITIZED_CLASSES.get(cls)
    if sub is None:
        ns = {f: _GuardedAttr(f)
              for f in getattr(cls, "__scheduler_owned__", ())}
        sub = type(cls.__name__ + "ThreadSanitized", (cls,), ns)
        _SANITIZED_CLASSES[cls] = sub
    return sub


class BlockPool:
    """Host-side refcounted allocator over the physical blocks of a
    paged KV-cache pool.

    Block 0 is the reserved NULL block: never allocated, the target of
    unused/dead block-table entries — whole-block prefill spill and the
    gated dead-row write land there and are never read (the attention
    mask excludes every logical slot past ``pos``). A block returns to
    the free list exactly when its LAST reference drops: slot tables
    and prefix-cache entries each hold one reference, so a shared
    prefix block outlives any single request that mounted it.
    Single-threaded by design — only the scheduler thread touches it.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(f"num_blocks must be >= 2 (the reserved "
                             f"null block + at least one usable), got "
                             f"{num_blocks}")
        self.num_blocks = num_blocks
        self._ref = [0] * num_blocks
        # LIFO free list: recently retired blocks are remounted first;
        # deterministic allocation order (tests rely on it), and holes
        # from mixed-length retirement are served like any other block
        # — physical contiguity is irrelevant, the table indirection IS
        # the defragmenter
        self._free = list(range(num_blocks - 1, 0, -1))
        #: high-water mark of blocks in use — the bytes_resident_peak
        #: observable (per-dtype residency for the bench rows)
        self.peak_in_use = 0

    @classmethod
    def from_bytes(cls, pool_bytes: int, block_bytes: int) -> "BlockPool":
        """Size the pool IN BYTES: as many usable blocks as
        ``block_bytes``-sized K/V payloads fit the budget, plus the
        reserved null block — the sizing rule under which an int8
        cache (half the payload bytes) genuinely doubles the block
        count at fixed HBM. Mirrors ``export_generator``'s
        ``pool_bytes`` math."""
        if block_bytes < 1:
            raise ValueError(f"block_bytes must be >= 1, got "
                             f"{block_bytes}")
        return cls(1 + pool_bytes // block_bytes)

    @property
    def usable(self) -> int:
        return self.num_blocks - 1

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.usable - len(self._free)

    def alloc(self, n: int) -> list[int]:
        """``n`` fresh blocks, refcount 1 each — all-or-nothing (a
        caller never holds a partial run)."""
        faults.inject("pool.alloc", detail=f"n={n}")
        if n > len(self._free):
            raise BlocksExhaustedError(
                f"need {n} cache block(s), {len(self._free)} free "
                f"(pool of {self.usable} usable blocks)")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return out

    def retain(self, blocks) -> None:
        for b in blocks:
            if self._ref[b] <= 0:
                raise AssertionError(f"retain of free block {b}")
            self._ref[b] += 1

    def release(self, blocks) -> None:
        for b in blocks:
            self._ref[b] -= 1
            if self._ref[b] < 0:
                raise AssertionError(f"double release of block {b}")
            if self._ref[b] == 0:
                self._free.append(b)

    def refcount(self, block: int) -> int:
        return self._ref[block]


class PrefixCache:
    """Block-granularity prefix reuse: hash of a token prefix -> the
    physical blocks whose K/V bytes ARE that prefix's.

    Entries exist at every full-block boundary of an admitted cold
    prompt (key = its first ``j * block_size`` tokens, value = its
    first ``j`` blocks) plus one EXACT whole-prompt entry when the
    prompt ends mid-block (value includes the partial tail block). The
    left-aligned paged layout makes the cached bytes position-
    independent facts of the token prefix — token i always sits at
    logical slot i — so a hit mounts the blocks by reference (retain),
    no copy. Each entry holds one refcount per block; LRU eviction
    releases entries until the allocator can serve again, and a block
    still mounted by a live slot simply survives its cache eviction.
    """

    def __init__(self, pool: BlockPool, block_size: int, *,
                 registry: Registry | None = None):
        self.pool = pool
        self.block_size = block_size
        # key -> (blocks tuple, covered token count); insertion order
        # doubles as LRU (move_to_end on touch)
        self._entries: OrderedDict[bytes, tuple[tuple[int, ...], int]] \
            = OrderedDict()
        # registry-backed counters (the engine hands in ITS registry so
        # /stats, /metrics and the engine counters stay one source of
        # truth; standalone unit tests get a private one)
        self.registry = registry if registry is not None else Registry()
        self._c_hits = self.registry.counter(
            "serving_prefix_cache_hits_total",
            "admissions served (fully or partially) from cached blocks")
        self._c_misses = self.registry.counter(
            "serving_prefix_cache_misses_total",
            "admissions with no cached prefix (cold prefill)")

    @property
    def hits(self) -> int:
        return self._c_hits.value

    @property
    def misses(self) -> int:
        return self._c_misses.value

    def record_hit(self) -> None:
        self._c_hits.inc()

    def record_miss(self) -> None:
        self._c_misses.inc()

    @staticmethod
    def _key(tokens: np.ndarray) -> bytes:
        return np.ascontiguousarray(tokens, np.int32).tobytes()

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, tokens: np.ndarray, *,
               record: bool = True) -> tuple[int, tuple[int, ...]]:
        """Longest cached prefix of ``tokens``: ``(n_tokens_hit,
        blocks)`` — the exact whole-prompt entry wins, else the longest
        full-block chain; ``(0, ())`` on a miss. Mounting (refcounting)
        is the caller's move. ``record=False`` skips the hit/miss
        counters — for probes that may not lead to an admission (a
        block-pressure deferral retries the same request every step,
        and one admission must count once)."""
        bs = self.block_size
        p = int(tokens.size)
        probes = [p] + [j * bs for j in range(p // bs, 0, -1)
                        if j * bs != p]
        for n in probes:
            key = self._key(tokens[:n])
            e = self._entries.get(key)
            if e is not None:
                self._entries.move_to_end(key)
                if record:
                    self._c_hits.inc()
                return n, e[0]
        if record:
            self._c_misses.inc()
        return 0, ()

    def insert(self, tokens: np.ndarray, blocks) -> None:
        """Record a cold prompt's block run: one entry per full-block
        boundary plus the exact whole-prompt entry. Re-inserting a
        known key only touches its LRU position."""
        bs = self.block_size
        p = int(tokens.size)
        ends = sorted({*(j * bs for j in range(1, p // bs + 1)), p})
        for n in ends:
            nb = -(-n // bs)
            key = self._key(tokens[:n])
            if key in self._entries:
                self._entries.move_to_end(key)
                continue
            ref = tuple(int(b) for b in blocks[:nb])
            self.pool.retain(ref)
            self._entries[key] = (ref, n)

    def evict(self, need_free: int) -> None:
        """Release LRU entries until ``need_free`` blocks are free (or
        the cache is empty — blocks still mounted by live slots stay
        resident past their entry's eviction)."""
        while self.pool.free_count < need_free and self._entries:
            _, (blocks, _) = self._entries.popitem(last=False)
            self.pool.release(blocks)


class NgramDrafter:
    """Per-request self-drafting cache: prompt-lookup / n-gram
    speculation (Saxena, "Prompt Lookup Decoding") over the request's
    OWN context — prompt tokens plus everything it has generated.

    The index maps every n-gram (n <= ``max_ngram``) ending at or
    before the second-to-last position to its most recent start, so
    :meth:`propose` finds the latest PRIOR occurrence of the current
    suffix in O(max_ngram) dict probes and proposes the tokens that
    followed it — repetitive text (code, templated prose, the
    fixed-point loops untrained models collapse into) drafts itself.
    No second model, no device work: the drafter is pure host-side
    bookkeeping the scheduler thread owns with its slot."""

    __slots__ = ("tokens", "max_ngram", "_index")

    def __init__(self, tokens, max_ngram: int = 3):
        if max_ngram < 1:
            raise ValueError(f"max_ngram must be >= 1, got {max_ngram}")
        self.max_ngram = int(max_ngram)
        self.tokens: list[int] = []
        self._index: dict[tuple[int, ...], int] = {}
        for t in tokens:
            self.extend(int(t))

    def __len__(self) -> int:
        return len(self.tokens)

    def extend(self, tok: int) -> None:
        """Append one context token. Indexes the n-grams ending at the
        PREVIOUS last position — the current suffix is never its own
        lookup hit, so a proposal always continues a strictly prior
        occurrence."""
        self.tokens.append(int(tok))
        end = len(self.tokens) - 1
        for n in range(1, self.max_ngram + 1):
            start = end - n
            if start < 0:
                break
            self._index[tuple(self.tokens[start:end])] = start

    def propose(self, k: int) -> list[int]:
        """Up to ``k`` draft tokens: the continuation after the most
        recent prior occurrence of the LONGEST matching suffix n-gram;
        ``[]`` when no suffix of length <= max_ngram recurs (the slot
        then falls back to the normal single-token step)."""
        if k < 1 or len(self.tokens) < 2:
            return []
        for n in range(min(self.max_ngram, len(self.tokens) - 1), 0, -1):
            start = self._index.get(tuple(self.tokens[-n:]))
            if start is not None:
                j = start + n
                return self.tokens[j:j + k]
        return []


#: request priority classes, best first — admission order, the shed
#: ladder, and the payload/--default_priority validation all key on
#: this tuple
PRIORITIES = ("interactive", "batch", "best_effort")
_PRIO_RANK = {p: i for i, p in enumerate(PRIORITIES)}

#: the brownout ladder: each level sheds the classes ranked at or
#: below it (level 1 sheds best_effort, 2 sheds batch too, 3 is
#: interactive-only and also evicts queued non-interactive requests)
PRESSURE_STATES = ("healthy", "shed_best_effort", "shed_batch",
                   "interactive_only")

#: saturation-score thresholds to ENTER each pressure level (index 1
#: onward), and the hysteresis subtracted to EXIT — a score oscillating
#: on a boundary cannot flap the state (and with it the router's view
#: of this replica) every scheduler iteration
PRESSURE_ENTER = (0.50, 0.75, 0.90)
PRESSURE_HYSTERESIS = 0.10


def compute_pressure_level(prev_level: int, score: float) -> int:
    """The shedding ladder's transition rule: the new level for a
    saturation ``score`` in [0, 1+] given the current level, with
    hysteresis — a level is entered at ``PRESSURE_ENTER[level-1]`` and
    exited only below that bound minus ``PRESSURE_HYSTERESIS``. Pure
    (unit-testable without an engine); the engine feeds it
    max(queue-depth fraction, queue-age fraction, block-starvation
    deferral EMA) once per scheduler iteration."""
    level = 0
    for i, bound in enumerate(PRESSURE_ENTER):
        enter = bound
        if prev_level > i:          # already at/above: exit bound
            enter = bound - PRESSURE_HYSTERESIS
        if score >= enter:
            level = i + 1
    return level


def select_index(queue, now: float, *, aging_s: float) -> int:
    """Index of the next request to admit from ``queue`` (a sequence
    of :class:`GenRequest`): best priority class first, earliest
    deadline first within a class (no deadline sorts last), queue
    order (FIFO) on ties. AGING promotes a waiting request one class
    per ``aging_s`` waited — UNBOUNDED below zero, so not only can a
    ``best_effort`` request never starve behind a sustained
    ``interactive`` stream, a deadline-LESS request can never starve
    behind a sustained stream of deadline-carrying siblings of its
    own class either (EDF only orders within an effective rank; an
    aged request eventually outranks every newcomer outright).
    ``aging_s <= 0`` disables aging. Pure — the no-starvation test
    drives it with an injected clock, no engine and no sleeps. With
    every request at the default class and no deadlines the winner is
    index 0: plain FIFO (the oldest request is both first in queue
    order and most aged), so the priority machinery is a bitwise
    no-op for priority-less traffic."""
    best, best_key = 0, None
    for i, r in enumerate(queue):
        rank = _PRIO_RANK.get(r.priority, 0)
        if aging_s > 0:
            rank -= int((now - r.submitted_at) / aging_s)
        key = (rank, r.deadline_t if r.deadline_t else float("inf"), i)
        if best_key is None or key < best_key:
            best, best_key = i, key
    return best


class RetryAfterEstimator:
    """Retry-After from MEASURED service rate: an EMA over decode-step
    wall times × the estimated steps until a slot frees (scaled by how
    many admission waves the queue ahead represents). Replaces the
    round-9 queue-depth linear guess, which knew nothing about how
    fast steps actually drain.

    Speculative decoding breaks the one-dispatch-one-token identity a
    remaining-token count silently assumed: a slot with T tokens to go
    frees after ~T / (tokens-per-dispatch) dispatches, not T. The
    estimator therefore also keeps a tokens-per-dispatch EMA (seeded
    at the spec-off truth of exactly 1.0, fed the mean per-row advance
    of every dispatch) and :meth:`dispatches_for` converts row-steps
    to dispatches through it — with speculation off the divisor stays
    exactly 1.0, so the pre-spec arithmetic is bitwise unchanged.

    Chunked prefill (round 18) shares the scheduler iteration with
    decode dispatches, and a chunk's wall time is a PROMPT-side cost a
    decode-step estimate must never absorb: one long-prompt admission
    would otherwise inflate the decode EMA and every queue-full
    Retry-After with it. The EMA is therefore SPLIT — decode
    dispatches feed :meth:`observe` (``ema_step_s``, exactly as
    before), chunk dispatches feed :meth:`observe_prefill`
    (``ema_prefill_chunk_s``) — and :meth:`time_for` prices a
    request's remaining work from both components (the feasibility
    shed's input), while :meth:`estimate` keeps reading the pure
    decode EMA."""

    def __init__(self, alpha: float = 0.2):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self.ema_step_s: float | None = None
        #: mean tokens one dispatch advances a live row by — exactly
        #: 1.0 until a verify dispatch accepts a draft
        self.ema_tokens_per_dispatch: float = 1.0
        #: EMA over chunked-prefill dispatch wall times — None until a
        #: chunk dispatched; NEVER folded into ema_step_s (the split
        #: that keeps Retry-After a decode measurement under chunked
        #: prefill)
        self.ema_prefill_chunk_s: float | None = None

    def observe(self, step_s: float) -> None:
        if self.ema_step_s is None:
            self.ema_step_s = float(step_s)
        else:
            self.ema_step_s += self.alpha * (step_s - self.ema_step_s)

    def observe_prefill(self, chunk_s: float) -> None:
        """Feed one chunked-prefill dispatch's wall time — the
        prefill-side EMA, kept apart from the decode-step EMA by
        construction."""
        if self.ema_prefill_chunk_s is None:
            self.ema_prefill_chunk_s = float(chunk_s)
        else:
            self.ema_prefill_chunk_s += self.alpha * (
                float(chunk_s) - self.ema_prefill_chunk_s)

    def time_for(self, row_steps: float, *,
                 prefill_chunks: int = 0) -> float | None:
        """Expected seconds to run ``row_steps`` decode row-steps plus
        ``prefill_chunks`` chunk dispatches, each priced by its OWN
        EMA (a chunk falls back to the decode EMA only before any
        chunk was measured). None before any decode signal exists —
        the feasibility shed must never act on a fake estimate."""
        if self.ema_step_s is None:
            return None
        t = self.ema_step_s * self.dispatches_for(row_steps)
        if prefill_chunks:
            per = (self.ema_prefill_chunk_s
                   if self.ema_prefill_chunk_s is not None
                   else self.ema_step_s)
            t += per * prefill_chunks
        return t

    def observe_advance(self, mean_tokens: float) -> None:
        """Feed one dispatch's mean per-row advance (1.0 for a normal
        step; 1 + accepted/rows for a verify dispatch)."""
        self.ema_tokens_per_dispatch += self.alpha * (
            float(mean_tokens) - self.ema_tokens_per_dispatch)

    def dispatches_for(self, row_steps: float) -> float:
        """Remaining row-steps (forced + tokens to go) -> expected
        DISPATCHES until they drain, through the measured
        tokens-per-dispatch (clamped at 1.0 — a dispatch never
        advances a row by less than one step)."""
        return float(row_steps) / max(1.0, self.ema_tokens_per_dispatch)

    @property
    def seeded(self) -> bool:
        """True once any completion fed the EMA — the :predict batcher
        seeds from micro-batch wall time on its FIRST completed batch
        (a predict-only replica must not answer the 1.0 pre-signal
        default forever), the engine from decode-step wall time, and
        the fleet router's per-replica estimators from forward wall
        time of EITHER verb."""
        return self.ema_step_s is not None

    def estimate(self, steps_to_free: float, *, queue_ahead: int = 0,
                 slots: int = 1) -> float:
        """Seconds until the caller plausibly gets a slot: EMA step
        latency × steps-to-free × admission waves ahead. 1.0 before
        any step has been measured (no signal beats a fake one)."""
        if self.ema_step_s is None:
            return 1.0
        waves = 1.0 + queue_ahead / max(1, slots)
        return max(0.1, self.ema_step_s * max(1.0, steps_to_free)
                   * waves)


def percentile(samples, q: float) -> float:
    """Nearest-rank percentile of an unsorted sample list (0 when
    empty) — the /stats latency figures."""
    if not samples:
        return 0.0
    s = sorted(samples)
    idx = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
    return float(s[idx])


def filter_logits_np(logits: np.ndarray, top_k: int,
                     top_p: float) -> np.ndarray:
    """Host-side mirror of ``GPT._filter_logits`` (same >=-threshold
    tie semantics) on one [V] f32 row: everything outside the kept set
    drops to -inf."""
    out = logits.astype(np.float64, copy=True)
    if top_k:
        kth = np.sort(out)[-top_k]
        out[out < kth] = -np.inf
    if top_p > 0.0:
        sl = np.sort(out)[::-1]
        e = np.exp(sl - sl[0])
        probs = e / e.sum()
        keep = (np.cumsum(probs) - probs) < top_p
        thresh = sl[keep].min()
        out[out < thresh] = -np.inf
    return out


# eq=False: a request is an IDENTITY object — the deadline/cancel
# paths remove specific instances from the queue (deque.remove), and
# the generated field-wise __eq__ would compare numpy prompts of
# different lengths (a broadcast ValueError that escalated to the
# engine-fatal handler — caught by the chaos soak's deadline storm)
@dataclasses.dataclass(eq=False)
class GenRequest:
    """One queued ``:generate`` request (per-request sampling knobs —
    the artifact's baked values are only the defaults)."""
    prompt: np.ndarray              # [p] int32, 1 <= p <= prompt_len
    max_new: int
    temperature: float
    top_k: int
    top_p: float
    seed: int
    eos_id: int | None
    pad_id: int
    # request-scoped observability: the id travels from HTTP admission
    # to retirement (response field, trace-span args, JSONL event);
    # the stamps become the per-request `timings` breakdown
    request_id: str = ""
    # deadline_ms=0 means no deadline; deadline_t is the absolute
    # perf_counter instant the scheduler enforces between steps
    deadline_ms: int = 0
    deadline_t: float = 0.0
    # admission class (PRIORITIES): orders the queue (select_index)
    # and names the brownout ladder rung that sheds this request
    priority: str = "interactive"
    # host-side stop sequences: generation retires the moment the
    # emitted tokens end with any of these, the match itself truncated
    # from the output (checked after EVERY accepted token, so the
    # speculative path truncates at the same boundary)
    stop_sequences: list[list[int]] = dataclasses.field(
        default_factory=list)
    # per-request speculative width: None = the engine's --spec_tokens
    # default, 0 = off for this request, 2..engine width = a cap
    spec_tokens: int | None = None
    # propagated distributed-trace context (trace_id/parent_id span
    # args from the router's traceparent header; {} = local-only) —
    # merged into every span this request's lifecycle records, so the
    # fleet stitcher parents the slot lane under the router's attempt
    trace: dict = dataclasses.field(default_factory=dict)
    future: Future = dataclasses.field(default_factory=Future)
    submitted_at: float = dataclasses.field(default_factory=time.perf_counter)
    t_admit: float = 0.0            # popped from the queue (slot owned)
    t_first: float = 0.0            # first sampled token emitted
    timings: dict | None = None     # set just before future resolves
    # terminal-outcome accounting latch (round 19): the SLO served/
    # good counters and the request-log outcome event fire exactly
    # once per request no matter which failure path retires it
    accounted: bool = False

    def sampler(self):
        """The per-request host RNG stream: a seeded Philox generator,
        one Gumbel draw vector per emitted token — deterministic given
        (seed, token index)."""
        return np.random.Generator(np.random.Philox(key=self.seed))


class EngineHandle:
    """Client-side handle on one submitted request: the future plus the
    cancellation lever. :meth:`result` CANCELS the request when the
    wait times out — the round-9 behavior (abandon the future, slot
    keeps decoding to ``max_new`` while holding cache blocks) was a
    slot/HBM leak with no owner; now a timed-out client provably
    returns its resources to the pool."""

    __slots__ = ("_engine", "req")

    def __init__(self, engine: "GenerationEngine", req: GenRequest):
        self._engine = engine
        self.req = req

    @property
    def request_id(self) -> str:
        return self.req.request_id

    @property
    def timings(self) -> dict | None:
        return self.req.timings

    def done(self) -> bool:
        return self.req.future.done()

    def cancel(self) -> bool:
        """Ask the engine to cancel this request (queued: failed
        immediately; live: retired at the next step boundary, blocks
        released). False when the request already retired."""
        return self._engine.cancel(self.req.request_id)

    def result(self, timeout: float | None = None) -> list[int]:
        """The generated tokens, or the request's failure. A wait that
        times out cancels the request before re-raising, so the slot
        and its cache blocks are released instead of leaking."""
        try:
            return self.req.future.result(timeout)
        except (TimeoutError, _FutureTimeout):
            # a DeadlineExceededError set BY the engine lands here too
            # (TimeoutError subclass): cancel() then returns False —
            # the request already retired — and the original re-raises
            if self.cancel():
                raise TimeoutError(
                    f"request {self.req.request_id} still running after "
                    f"{timeout}s — cancelled (slot and cache blocks "
                    "released)") from None
            raise


class _Slot:
    """Scheduler-side state of one live cache-pool row."""

    def __init__(self, req: GenRequest, index: int, pad: int, pos: int,
                 rng, seq: int = 0):
        self.req = req
        self.index = index
        # admission order, engine-wide: the re-dispatch protocol evicts
        # the NEWEST-admitted slot on repeated decode failure (the most
        # recent composition change is the most likely poison)
        self.admit_seq = seq
        self.pad = pad
        self.pos = pos                  # next cache slot to be written
        self.rng = rng
        self.tokens: list[int] = []
        self.last_tok = 0
        # span boundaries for this slot's trace lane (perf_counter)
        self.t_prefill_done = 0.0
        self.t_forced_done = 0.0
        # paged prefix-reuse admission: KNOWN prompt tokens still to be
        # fed through the shared step (teacher-forced — their logits
        # are discarded until the last one, whose logits are the first
        # sample point). Empty on the cold/prefill path.
        self.forced: list[int] = []
        # partial-hit admissions: the full prompt to insert into the
        # prefix cache once the forced suffix has been written — so an
        # identical repeat becomes an exact hit instead of re-forcing
        # the suffix forever (None = cold path inserted at prefill, or
        # exact hit whose entries already exist)
        self.pending_insert: np.ndarray | None = None
        # ---- speculative decoding (round 16) ------------------------
        #: tokens emitted so far (>= len(tokens): a matched stop
        #: sequence truncates `tokens` but the emission happened)
        self.emitted = 0
        #: the per-request prompt-lookup drafter (None: spec off for
        #: this request — sampled, or disabled by knob)
        self.drafter: NgramDrafter | None = None
        #: drafts riding the CURRENT verify dispatch (empty outside one)
        self.draft: list[int] = []
        #: accepted draft tokens over the request's lifetime (the
        #: `spec_accepted` timings field)
        self.spec_accepted = 0
        # ---- chunked prefill (round 18) -----------------------------
        #: prompt tokens already written by chunk dispatches; only
        #: meaningful while the slot sits in the engine's _prefilling
        #: set (a slot joins _live with the prompt fully resident)
        self.chunk_done = 0

    def remaining_steps(self) -> int:
        """ROW-STEPS until this slot retires at its max_new bound (EOS
        may retire it sooner) — the Retry-After steps-to-free signal;
        the estimator converts row-steps to dispatches through its
        tokens-per-dispatch EMA (1:1 without speculation)."""
        return len(self.forced) + max(1, self.req.max_new
                                      - self.emitted)


@scheduler_owned("_pool", "_live", "_free", "_admitting", "_tables",
                 "blocks", "prefix_cache", "_slot_freed_t", "_retry",
                 "_steps_to_free_hint", "_admit_counter", "_prefilling")
class GenerationEngine:
    """The continuous-batching scheduler (see module docstring).

    ``submit`` is thread-safe (called from HTTP handler threads); all
    executable calls happen on the single scheduler thread, so the
    engine is also the generate path's single-flight discipline. The
    ``@scheduler_owned`` fields above are that discipline made
    explicit: only ``@scheduler_thread`` methods may touch them
    (``@snapshot_view`` methods may read), checked statically by
    graftlint's THR01 rule and — under ``thread_sanitizer=True`` — on
    every attribute access at runtime (a debug mode; disabled, the
    class is untouched and the hot path pays nothing).
    """

    def __init__(self, stepwise: StepwiseGenerator, *,
                 max_queue: int = 64, prefix_cache: bool = True,
                 registry: Registry | None = None,
                 metrics_logger=None, thread_sanitizer: bool = False,
                 default_deadline_ms: int = 0,
                 drain_timeout_s: float = 30.0,
                 stall_after_s: float = 10.0,
                 spec_tokens: int = 0,
                 prefill_chunk_tokens: int = 0,
                 default_priority: str = "interactive",
                 priority_aging_ms: int = 2000,
                 shed_policy: str = "auto",
                 pressure_age_budget_s: float = 5.0,
                 process: str = "serving",
                 flight_recorder=None):
        self.sw = stepwise
        # the trace-lane process label: "serving" standalone; an
        # in-process fleet gives each replica its own so the shared
        # ring's per-process drain (GET /trace/export) segregates
        self.process = str(process)
        # optional obs.flightrec.FlightRecorder: the engine-fatal and
        # poison-eviction seams dump incident bundles through it
        self._flightrec = flight_recorder
        m = stepwise.step_meta
        self.slots: int = int(m["slots"])
        self.prompt_len: int = int(m["prompt_len"])
        self.max_new_cap: int = int(m["max_new_tokens"])
        meta = stepwise.meta
        self.defaults = {
            "temperature": float(meta.get("temperature", 0.0)),
            "top_k": int(meta.get("top_k", 0)),
            "top_p": float(meta.get("top_p", 0.0)),
            "eos_id": meta.get("eos_id"),
            "pad_id": int(meta.get("pad_id", 0)),
        }
        self.max_queue = max_queue
        self._pool = stepwise.make_pool()
        self._queue: deque[GenRequest] = deque()
        self._cond = threading.Condition()
        self._live: dict[int, _Slot] = {}
        self._free = list(range(self.slots))[::-1]   # pop() -> slot 0 first
        self._running = False
        self._closed = False
        self._thread: threading.Thread | None = None
        # the request currently being prefilled (popped from the queue
        # but not yet live) — the fault handler must fail it too
        self._admitting: GenRequest | None = None
        # ---- self-healing state (round 14) --------------------------
        if default_deadline_ms < 0:
            raise ValueError(f"default_deadline_ms must be >= 0 "
                             f"(0 = no deadline), got "
                             f"{default_deadline_ms}")
        self.default_deadline_ms = int(default_deadline_ms)
        self.drain_timeout_s = float(drain_timeout_s)
        self.stall_after_s = float(stall_after_s)
        # stop admitting, finish in-flight: flipped by drain()
        self._draining = False
        # request ids popped from the queue and not yet retired —
        # shared under _cond so cancel()/drain()/health() can answer
        # without touching the scheduler-owned _live map
        self._inflight_ids: set[str] = set()
        # cancellations awaiting the scheduler's next step boundary
        self._cancel_ids: set[str] = set()
        # monotonic heartbeat the scheduler bumps every iteration (a
        # plain float: atomic to read cross-thread, like
        # _steps_to_free_hint) — the watchdog's signal
        self._heartbeat: float = time.monotonic()
        # the idle park must wake (and bump the heartbeat) well inside
        # stall_after_s: at the old fixed 0.5 s granularity an IDLE
        # engine under a sub-half-second watchdog threshold flapped
        # live->stalled between wakeups, so a fleet prober
        # (serving_router) would demote a perfectly healthy replica
        self._idle_wait_s = (min(0.5, max(0.01, stall_after_s / 4.0))
                             if stall_after_s > 0 else 0.5)
        # admission sequence for the eviction order (newest first)
        self._admit_counter = 0
        # ---- telemetry: ALL counters live in the registry (one lock,
        # atomic snapshot) — /stats, /metrics and the legacy attribute
        # reads below are views of the same values. An optional
        # MetricsLogger gets one structured JSONL event per retired
        # request (request_id + timings breakdown).
        self.registry = registry if registry is not None else Registry(
            namespace="serving")
        self.metrics_logger = metrics_logger
        reg = self.registry
        self._c_prefills = reg.counter(
            "serving_prefills_total", "prefill program dispatches")
        self._c_decode_steps = reg.counter(
            "serving_decode_steps_total", "shared decode dispatches")
        self._c_decode_slot_steps = reg.counter(
            "serving_decode_slot_steps_total",
            "sum of live slots over decode dispatches")
        self._c_admissions = reg.counter(
            "serving_admissions_total",
            "requests reaching an admission outcome (prefill, "
            "prefix-cache mount, or loud failure)")
        self._c_requests_done = reg.counter(
            "serving_requests_done_total", "requests retired normally")
        self._c_requests_failed = reg.counter(
            "serving_requests_failed_total",
            "requests failed loudly (block exhaustion, engine fault)")
        self._c_tokens_out = reg.counter(
            "serving_tokens_out_total", "tokens sampled across requests")
        self._c_cancelled = reg.counter(
            "serving_cancelled_total",
            "requests cancelled (POST /cancel, handle.cancel(), or a "
            "timed-out EngineHandle.result)")
        self._c_deadline = reg.counter(
            "serving_deadline_expired_total",
            "requests retired by deadline_ms expiry (queued or live)")
        self._c_redispatches = reg.counter(
            "serving_redispatches_total",
            "shared decode dispatches repeated by the re-dispatch "
            "protocol (transient retry, or survivors after a poison "
            "eviction)")
        self._g_drain_ms = reg.gauge(
            "serving_drain_ms",
            "wall-clock milliseconds the last graceful drain took")
        # speculative-decoding observables (round 16): registered
        # unconditionally so /stats//metrics keys are stable; all zero
        # while spec_tokens=0
        self._c_spec_proposed = reg.counter(
            "serving_spec_proposed_total",
            "draft tokens offered to verify dispatches by the "
            "per-request prompt-lookup drafters")
        self._c_spec_accepted = reg.counter(
            "serving_spec_accepted_total",
            "draft tokens accepted by the exact greedy rejection rule")
        self._c_spec_emitted = reg.counter(
            "serving_spec_emitted_total",
            "tokens emitted by draft-carrying rows of verify "
            "dispatches (accepted drafts + the correction/bonus token)")
        self._c_verify_steps = reg.counter(
            "serving_verify_steps_total",
            "K-token speculative verify dispatches (the spec path's "
            "analogue of serving_decode_steps_total)")
        self._g_accept_rate = reg.gauge(
            "serving_spec_accept_rate",
            "accepted / proposed draft tokens over the engine's "
            "lifetime (0 until any draft was offered)")
        self._g_queue_depth = reg.gauge(
            "serving_queue_depth", "requests waiting for admission")
        self._g_live_slots = reg.gauge(
            "serving_live_slots", "cache-pool slots currently decoding")
        # ---- SLO/overload observables (round 18): registered
        # unconditionally so /stats//metrics keys are stable; zeros
        # while chunking/shedding never trigger
        self._c_prefill_chunks = reg.counter(
            "serving_prefill_chunks_total",
            "chunked-prefill dispatches (prefill_chunk_tokens > 0)")
        self._c_shed = reg.counter(
            "serving_shed_total",
            "requests shed with 429 + measured Retry-After by the "
            "brownout ladder or the feasibility rule (all classes)")
        self._c_shed_class = {
            "interactive": reg.counter(
                "serving_shed_interactive_total",
                "interactive requests shed (feasibility only — the "
                "brownout ladder never sheds interactive)"),
            "batch": reg.counter(
                "serving_shed_batch_total",
                "batch requests shed by the ladder or feasibility"),
            "best_effort": reg.counter(
                "serving_shed_best_effort_total",
                "best_effort requests shed by the ladder or "
                "feasibility"),
        }
        self._c_shed_infeasible = reg.counter(
            "serving_shed_infeasible_total",
            "queued requests shed because their deadline_ms was "
            "already unmeetable at the measured service rate (429 "
            "now instead of a 504 after wasted queue time)")
        self._c_pressure_transitions = reg.counter(
            "serving_pressure_transitions_total",
            "brownout ladder state changes (either direction)")
        self._g_pressure_level = reg.gauge(
            "serving_pressure_level",
            "current brownout rung (0 healthy .. 3 interactive_only)")
        self._g_queue_age = reg.gauge(
            "serving_queue_age_seconds",
            "age of the oldest queued request (0 when the queue is "
            "empty) — the saturation signal /healthz republishes")
        self._g_prefilling_slots = reg.gauge(
            "serving_prefilling_slots",
            "slots mid-chunked-prefill (holding blocks, not yet "
            "decoding)")
        self._h_decode_stall = reg.histogram(
            "serving_decode_stall_seconds",
            "gap between consecutive shared dispatches as seen by "
            "slots that stayed live across it — the decode-stall-"
            "under-long-prompt proof surface chunked prefill bounds",
            buckets=SERVING_LATENCY_BUCKETS)
        # perf_counter stamp of the previous shared dispatch while any
        # slot survived it (scheduler-thread-only scalar)
        self._last_dispatch_t: float = 0.0
        # request-phase histograms register the AUDITED bucket set
        # (obs/registry.py SERVING_LATENCY_BUCKETS): sub-ms bounds for
        # the µs-scale queue/prefill phases the 1ms-floored default
        # collapsed into one bucket; the load harness's saturation
        # check pins that none of these overflows its top finite bound
        self._h_latency = reg.histogram(
            "serving_request_latency_seconds",
            "submit-to-retirement request latency",
            buckets=SERVING_LATENCY_BUCKETS)
        self._h_queue_wait = reg.histogram(
            "serving_request_queue_seconds",
            "submit-to-admission queue wait",
            buckets=SERVING_LATENCY_BUCKETS)
        self._h_prefill = reg.histogram(
            "serving_request_prefill_seconds",
            "admission-to-first-sample time (prefill or cached mount + "
            "teacher-forced suffix)",
            buckets=SERVING_LATENCY_BUCKETS)
        self._h_decode = reg.histogram(
            "serving_request_decode_seconds",
            "first-sample-to-retirement decode time",
            buckets=SERVING_LATENCY_BUCKETS)
        # ---- SLO attainment observables (round 19): every request
        # reaching a terminal outcome (retired, shed, expired,
        # cancelled, failed) counts served for its class EXACTLY ONCE
        # (_account_outcome); good additionally requires a normal
        # retirement within the request's own deadline. The per-class
        # pairs are what obs/slo.py's hit_rate objectives window over;
        # the aggregate pair keeps the classless fleet ratio cheap.
        # Blunt queue-full and draining refusals are NOT served: they
        # precede admission accounting and the client retries them.
        self._c_slo_served_all = reg.counter(
            "serving_slo_served_total",
            "requests reaching any terminal outcome (all classes) — "
            "the SLO attainment denominator")
        self._c_slo_good_all = reg.counter(
            "serving_slo_good_total",
            "requests retired normally within their deadline (all "
            "classes) — the SLO attainment numerator")
        self._c_slo_served = {
            "interactive": reg.counter(
                "serving_slo_served_interactive_total",
                "interactive requests reaching a terminal outcome"),
            "batch": reg.counter(
                "serving_slo_served_batch_total",
                "batch requests reaching a terminal outcome"),
            "best_effort": reg.counter(
                "serving_slo_served_best_effort_total",
                "best_effort requests reaching a terminal outcome"),
        }
        self._c_slo_good = {
            "interactive": reg.counter(
                "serving_slo_good_interactive_total",
                "interactive requests retired within deadline"),
            "batch": reg.counter(
                "serving_slo_good_batch_total",
                "batch requests retired within deadline"),
            "best_effort": reg.counter(
                "serving_slo_good_best_effort_total",
                "best_effort requests retired within deadline"),
        }
        self._c_goodput_tokens = reg.counter(
            "serving_goodput_tokens_total",
            "tokens emitted by good requests (retired within "
            "deadline) — goodput tps, distinct from raw "
            "serving_tokens_out_total throughput")
        # per-class latency histograms: the p95_ms objectives need the
        # interactive tail separable from batch/best_effort bulk —
        # the global serving_request_latency_seconds cannot give a
        # per-class quantile
        self._h_class_latency = {
            "interactive": reg.histogram(
                "serving_latency_interactive_seconds",
                "submit-to-retirement latency of interactive requests",
                buckets=SERVING_LATENCY_BUCKETS),
            "batch": reg.histogram(
                "serving_latency_batch_seconds",
                "submit-to-retirement latency of batch requests",
                buckets=SERVING_LATENCY_BUCKETS),
            "best_effort": reg.histogram(
                "serving_latency_best_effort_seconds",
                "submit-to-retirement latency of best_effort requests",
                buckets=SERVING_LATENCY_BUCKETS),
        }
        self._latencies: deque[float] = deque(maxlen=2048)
        # slot-lane bookkeeping: when slot i last freed, so a reused
        # slot's queue-wait span is clamped to its own tenancy (the
        # FULL wait is in timings/args — the lane must tile)
        self._slot_freed_t = [0.0] * self.slots
        self._retry = RetryAfterEstimator()
        # min remaining steps over live slots, refreshed by the
        # scheduler thread after each shared step — a plain float so
        # submit threads can read it without touching _live
        self._steps_to_free_hint: float = 1.0
        # ---- speculative decoding (round 16) ------------------------
        if spec_tokens < 0 or spec_tokens == 1:
            raise ValueError(
                f"spec_tokens must be 0 (off) or >= 2 (anchor + at "
                f"least one draft lane per verify dispatch), got "
                f"{spec_tokens}")
        art_spec = int(getattr(stepwise, "spec_tokens", 0))
        if spec_tokens:
            if not getattr(stepwise, "paged", False):
                raise ValueError(
                    "spec_tokens needs a PAGED stepwise artifact "
                    "(draft rejection rewinds per-row pos through the "
                    "block tables) — re-export with paged=True")
            if not art_spec:
                raise ValueError(
                    "spec_tokens > 0 but this artifact carries no "
                    "verify program — re-export with export_generator("
                    f"..., spec_tokens={spec_tokens}), or run with "
                    "spec_tokens=0")
            if spec_tokens > art_spec:
                raise ValueError(
                    f"spec_tokens {spec_tokens} exceeds this "
                    f"artifact's exported verify width {art_spec} "
                    "(spec_tokens in export.json) — re-export wider, "
                    "or lower the knob")
        #: requested speculative width (0 = off; <= the artifact's)
        self.spec_tokens = int(spec_tokens)
        #: the exported verify program's lane width (the dispatch
        #: shape); 0 when speculation is off for this engine
        self._verify_width = art_spec if spec_tokens else 0
        # ---- SLO-aware overload resilience (round 18) ---------------
        if default_priority not in PRIORITIES:
            raise ValueError(
                f"default_priority must be one of {PRIORITIES}, got "
                f"{default_priority!r}")
        if priority_aging_ms < 0:
            raise ValueError(
                f"priority_aging_ms must be >= 0 (0 disables aging), "
                f"got {priority_aging_ms}")
        if shed_policy not in ("auto", "off"):
            raise ValueError(f"shed_policy must be 'auto' or 'off', "
                             f"got {shed_policy!r}")
        if pressure_age_budget_s <= 0:
            raise ValueError(f"pressure_age_budget_s must be > 0, got "
                             f"{pressure_age_budget_s}")
        self.default_priority = default_priority
        self.priority_aging_s = priority_aging_ms / 1e3
        self.shed_policy = shed_policy
        self.pressure_age_budget_s = float(pressure_age_budget_s)
        art_chunk = int(getattr(stepwise, "prefill_chunk_tokens", 0))
        if prefill_chunk_tokens:
            if not getattr(stepwise, "paged", False):
                raise ValueError(
                    "prefill_chunk_tokens needs a PAGED stepwise "
                    "artifact (chunks fill whole blocks through the "
                    "table) — re-export with paged=True")
            if not art_chunk:
                raise ValueError(
                    "prefill_chunk_tokens > 0 but this artifact "
                    "carries no chunked-prefill program — re-export "
                    "with export_generator(..., prefill_chunk="
                    f"{prefill_chunk_tokens}), or run with "
                    "prefill_chunk_tokens=0")
            bs_chunk = int(stepwise.step_meta["block_size"])
            if prefill_chunk_tokens % bs_chunk:
                raise ValueError(
                    f"prefill_chunk_tokens {prefill_chunk_tokens} "
                    f"must be a multiple of block_size {bs_chunk} "
                    "(chunks tile the left-aligned layout block-"
                    "granularly)")
            if prefill_chunk_tokens > art_chunk:
                raise ValueError(
                    f"prefill_chunk_tokens {prefill_chunk_tokens} "
                    f"exceeds this artifact's exported chunk width "
                    f"{art_chunk} (prefill_chunk in export.json) — "
                    "re-export wider, or lower the knob")
        #: per-iteration chunked-prefill token budget (0 = off: cold
        #: admissions dispatch the monolithic prefill, bitwise the
        #: pre-round-18 behavior)
        self.prefill_chunk_tokens = int(prefill_chunk_tokens)
        #: the exported chunk program's static width (>= the budget)
        self._chunk_width = art_chunk if prefill_chunk_tokens else 0
        #: slots mid-chunked-prefill (index -> _Slot); scheduler-owned
        #: like _live — these slots hold blocks but never ride the
        #: shared decode dispatch until their final chunk lands
        self._prefilling: dict[int, _Slot] = {}
        #: brownout ladder position (index into PRESSURE_STATES); a
        #: plain int refreshed by the scheduler each iteration so
        #: submit threads and health() read it without locking (same
        #: convention as _steps_to_free_hint / _heartbeat)
        self._pressure_level: int = 0
        # block-starvation signal: raw pool occupancy is NOT pressure
        # (a healthy prefix cache keeps the pool deliberately full, and
        # its blocks are reclaimable) — what is pressure is admissions
        # actually DEFERRING for lack of blocks, so the score reads an
        # EMA over deferral-per-iteration instead
        self._block_deferred = False
        self._defer_ema = 0.0
        # ---- block-paged pool state (paged stepwise artifacts) ------
        self.paged: bool = bool(getattr(stepwise, "paged", False))
        self._c_tokens_saved = reg.counter(
            "serving_prefill_tokens_saved_total",
            "prompt tokens mounted from cached blocks instead of "
            "prefilled")
        self._c_cow = reg.counter(
            "serving_cow_copies_total",
            "copy-on-write block copies (divergence from a shared "
            "block)")
        # the cache pool's storage dtype ("int8" for the quantized
        # pool) — /stats and the bench rows report residency per dtype
        self.kv_cache_dtype: str = str(
            getattr(stepwise, "kv_cache_dtype",
                    m.get("kv_cache_dtype", m["cache_dtype"])))
        if self.paged:
            self.block_size = int(m["block_size"])
            self.num_blocks = int(m["num_blocks"])
            self.blocks_per_slot = int(m["blocks_per_slot"])
            self.prompt_blocks = int(m["prompt_blocks"])
            self.blocks = BlockPool(self.num_blocks)
            self._g_blocks_free = reg.gauge(
                "serving_blocks_free", "free physical cache blocks")
            self._g_bytes_resident = reg.gauge(
                "serving_bytes_resident",
                "bytes of K/V actually resident in allocated blocks")
            self._g_bytes_resident_peak = reg.gauge(
                "serving_bytes_resident_peak",
                "high-water mark of resident K/V bytes (incl. int8 "
                "scale rows) over the engine's lifetime")
            self._g_prefix_entries = reg.gauge(
                "serving_prefix_cache_entries",
                "live prefix-cache entries")
            self.prefix_cache = (PrefixCache(self.blocks,
                                             self.block_size,
                                             registry=reg)
                                 if prefix_cache else None)
            # per-slot block tables, host-owned (the decode program
            # takes them as a per-step operand; 0 = the null block)
            self._tables = np.zeros((self.slots, self.blocks_per_slot),
                                    np.int32)
            shape = m["pool_shape"]                # [L, N, Bs, H, D]
            # per-block residency incl. int8 scale rows: recorded at
            # export since round 12; the fallback recomputes the K/V
            # payload for pre-quant artifacts
            self._block_bytes = int(m.get("block_bytes") or (
                2 * int(np.prod([shape[0], shape[2], shape[3],
                                 shape[4]])) * _itemsize(
                    m["cache_dtype"])))
            self._copy_block = self._make_block_copy()
        else:
            self.prefix_cache = None
        # bytes one cached token costs at this artifact's kv dtype
        # (K+V payload + scale rows) — the /metrics-visible dtype
        # signal next to the string in /stats
        shape = m["pool_shape"]
        tok_bytes = 2 * int(np.prod([shape[0], shape[3], shape[4]])) \
            * _itemsize(m["cache_dtype"])
        if self.kv_cache_dtype == "int8":
            tok_bytes += 2 * int(shape[0]) * 4       # f32 scale rows
        self._g_kv_bytes_per_token = reg.gauge(
            "serving_kv_cache_bytes_per_token",
            "bytes one cached token occupies at the artifact's "
            "kv_cache_dtype (K+V payload plus int8 scale rows)")
        self._g_kv_bytes_per_token.set(tok_bytes)
        # ---- thread-ownership sanitizer (debug): swap onto the
        # guarded subclass LAST so __init__'s own stores stay plain.
        # The owner tid arms when the scheduler thread starts; until
        # then (tests pre-loading state, direct _admit() calls) every
        # thread passes. Disabled: no class swap, zero overhead.
        self.thread_sanitizer = thread_sanitizer
        self._san_tid: int | None = None
        self._san_view_cm = _NOOP_CM
        if thread_sanitizer:
            self._san_view_cm = _SNAPSHOT_READS
            self.__class__ = _sanitized_class(type(self))

    @staticmethod
    def _make_block_copy():
        """Device-side whole-block copy for copy-on-write, in place on
        every layer of every pool tensor, queued on the default stream
        like the decode step that then writes the copy (so the copy
        always lands first)."""
        def copy(pool, src, dst):
            for v in pool.values():
                v[:, dst].copy_(v[:, src])
            return pool

        return copy

    # ---- legacy counter views (tests and callers read these as ints;
    # the registry is the single owner) --------------------------------
    @property
    def prefills(self) -> int:
        return self._c_prefills.value

    @property
    def decode_steps(self) -> int:
        return self._c_decode_steps.value

    @property
    def decode_slot_steps(self) -> int:
        return self._c_decode_slot_steps.value

    @property
    def requests_done(self) -> int:
        return self._c_requests_done.value

    @property
    def tokens_out(self) -> int:
        return self._c_tokens_out.value

    @property
    def prefill_tokens_saved(self) -> int:
        return self._c_tokens_saved.value

    @property
    def cow_copies(self) -> int:
        return self._c_cow.value

    # ---- client side -------------------------------------------------
    def _make_request(self, prompt, *, max_new: int | None = None,
                      temperature: float | None = None,
                      top_k: int | None = None, top_p: float | None = None,
                      seed: int = 0, request_id: str | None = None,
                      deadline_ms: int | None = None,
                      stop_sequences=None,
                      spec_tokens: int | None = None,
                      priority: str | None = None,
                      eos_id: int | None = ...) -> GenRequest:
        """Validate client inputs into a :class:`GenRequest` — every
        check happens HERE, on the caller's thread, so nothing
        client-controlled can raise on the scheduler thread (where one
        bad request would poison every in-flight neighbor)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt needs at least one token")
        if prompt.size > self.prompt_len:
            raise ValueError(
                f"prompt length {prompt.size} exceeds this artifact's "
                f"exported prompt capacity {self.prompt_len} "
                "(prompt_len in export.json; re-export with a larger "
                "prompt_len to serve longer prompts)")
        if max_new is None:
            max_new = self.max_new_cap
        if not 1 <= max_new <= self.max_new_cap:
            raise ValueError(
                f"max_new {max_new} outside [1, {self.max_new_cap}] "
                "(max_new_tokens recorded in export.json)")
        d = self.defaults
        req = GenRequest(
            prompt=prompt, max_new=int(max_new),
            temperature=d["temperature"] if temperature is None
            else float(temperature),
            top_k=d["top_k"] if top_k is None else int(top_k),
            top_p=d["top_p"] if top_p is None else float(top_p),
            seed=int(seed),
            eos_id=d["eos_id"] if eos_id is ... else eos_id,
            pad_id=d["pad_id"],
            request_id=request_id or uuid.uuid4().hex[:12])
        if req.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got "
                             f"{req.temperature}")
        vocab = int(self.sw.step_meta.get("vocab_size", 0))
        if req.top_k < 0 or (vocab and req.top_k > vocab):
            raise ValueError(f"top_k must be in [0, vocab_size={vocab}],"
                             f" got {req.top_k}")
        if not 0.0 <= req.top_p <= 1.0:
            raise ValueError(f"top_p must be in [0, 1], got {req.top_p}")
        if (req.top_k or req.top_p) and req.temperature <= 0.0:
            raise ValueError(
                "top_k/top_p shape the SAMPLING distribution; greedy "
                "decoding (temperature=0) would silently ignore them — "
                "set temperature > 0")
        if priority is None:
            priority = self.default_priority
        if priority not in PRIORITIES:
            raise ValueError(
                f"priority must be one of {PRIORITIES}, got "
                f"{priority!r}")
        req.priority = priority
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        if isinstance(deadline_ms, bool) \
                or not isinstance(deadline_ms, (int, np.integer)) \
                or deadline_ms < 0:
            raise ValueError(
                f"deadline_ms must be a non-negative integer "
                f"(milliseconds; 0 = no deadline), got {deadline_ms!r}")
        if deadline_ms:
            req.deadline_ms = int(deadline_ms)
            req.deadline_t = req.submitted_at + deadline_ms / 1e3
        if stop_sequences is not None:
            if not isinstance(stop_sequences, (list, tuple)):
                raise ValueError(
                    f"stop_sequences must be a list of token-id "
                    f"sequences, got {type(stop_sequences).__name__}")
            if len(stop_sequences) > 16:
                raise ValueError(
                    f"at most 16 stop_sequences per request, got "
                    f"{len(stop_sequences)}")
            clean: list[list[int]] = []
            for i, ss in enumerate(stop_sequences):
                if not isinstance(ss, (list, tuple)) or not ss:
                    raise ValueError(
                        f"stop_sequences[{i}] must be a non-empty list "
                        f"of token ids, got {ss!r}")
                if len(ss) > 64:
                    raise ValueError(
                        f"stop_sequences[{i}] has {len(ss)} tokens "
                        "(bound: 64) — a stop sequence longer than any "
                        "plausible generation is a client bug")
                for t in ss:
                    if isinstance(t, bool) or not isinstance(
                            t, (int, np.integer)):
                        raise ValueError(
                            f"stop_sequences[{i}] holds a non-integer "
                            f"token {t!r}")
                clean.append([int(t) for t in ss])
            req.stop_sequences = clean
        if spec_tokens is not None:
            if isinstance(spec_tokens, bool) or not isinstance(
                    spec_tokens, (int, np.integer)) or spec_tokens < 0 \
                    or spec_tokens == 1:
                raise ValueError(
                    f"spec_tokens must be 0 (off) or >= 2 per request, "
                    f"got {spec_tokens!r}")
            if spec_tokens > self.spec_tokens:
                raise ValueError(
                    f"spec_tokens {spec_tokens} exceeds this engine's "
                    f"width {self.spec_tokens}"
                    + ("" if self.spec_tokens else
                       " (speculative decoding is off — start the "
                       "server with --spec_tokens K over an artifact "
                       "exported with a verify program)"))
            req.spec_tokens = int(spec_tokens)
        return req

    def _enqueue(self, reqs: list[GenRequest]) -> list[Future]:
        """Atomic admission: ALL requests fit in the queue or NONE are
        queued (a multi-row HTTP request must not strand its first
        rows generating for nobody when row k hits the bound)."""
        with self._cond:
            if self._closed:
                raise RuntimeError("engine is stopped")
            if self._draining:
                raise DrainingError(
                    "engine is draining (graceful shutdown): no new "
                    "admissions — retry later or against another "
                    "replica", retry_after=self._retry_after())
            if self.shed_policy == "auto" and self._pressure_level:
                level = self._pressure_level
                # rung N refuses the classes ranked >= max(1, 3-N):
                # 1 -> best_effort, 2 -> batch too, 3 stays
                # interactive-only (interactive is never ladder-shed)
                floor = max(1, len(PRIORITIES) - level)
                victims = [r for r in reqs
                           if _PRIO_RANK[r.priority] >= floor]
                if victims:
                    ra = self._retry_after()
                    with self.registry.atomic():
                        for r in victims:
                            self._c_shed.inc()
                            self._c_shed_class[r.priority].inc()
                            self._account_outcome(r, "shed")
                    raise ShedError(
                        f"shedding {victims[0].priority} requests "
                        f"under load (pressure "
                        f"{PRESSURE_STATES[level]}: queue "
                        f"{len(self._queue)}/{self.max_queue}) — "
                        "retry after the hint, or raise the "
                        "request's priority", retry_after=ra)
            if len(self._queue) + len(reqs) > self.max_queue:
                raise QueueFullError(
                    f"admission queue full ({len(self._queue)} waiting, "
                    f"{len(reqs)} requested, bound {self.max_queue})",
                    retry_after=self._retry_after())
            # queueing before start() is allowed (tests pre-load the
            # queue so the first admission wave is deterministic); the
            # scheduler drains it once the thread runs
            self._queue.extend(reqs)
            self._g_queue_depth.set(len(self._queue))
            self._cond.notify_all()
        return [r.future for r in reqs]

    def submit(self, prompt, **kw) -> EngineHandle:
        """Queue one request; returns its :class:`EngineHandle` (a
        future-shaped wrapper whose ``result(timeout)`` cancels on
        timeout instead of leaking the slot). Raises ``ValueError``
        for invalid client inputs (clear faults naming the limit),
        :class:`QueueFullError` at ``max_queue``, and
        :class:`DrainingError` during a graceful drain."""
        trace = kw.pop("trace", None)
        req = self._make_request(prompt, **kw)
        if trace:
            req.trace = dict(trace)
        self._enqueue([req])
        return EngineHandle(self, req)

    def submit_many(self, prompts, **kw) -> list[EngineHandle]:
        """Validate EVERY prompt, then queue all of them atomically —
        the multi-row request path (row i samples under ``seed + i``
        so rows stay independent)."""
        return [EngineHandle(self, r)
                for r in self.submit_many_requests(prompts, **kw)]

    def submit_many_requests(self, prompts, *,
                             request_ids: list[str] | None = None,
                             trace: dict | None = None,
                             **kw) -> list[GenRequest]:
        """Like :meth:`submit_many` but returns the
        :class:`GenRequest` objects, whose ``request_id``/``timings``
        the HTTP layer reads after the future resolves. ``request_ids``
        (one per prompt) propagates caller-supplied ids (the
        ``X-Request-Id`` path); ``trace`` (the parsed ``traceparent``
        span args) parents every row's lifecycle spans under the
        router's forward attempt instead of a fresh local root."""
        if request_ids is not None and len(request_ids) != len(prompts):
            raise ValueError(
                f"{len(request_ids)} request ids for {len(prompts)} "
                "prompts")
        seed = kw.pop("seed", 0)
        reqs = [self._make_request(
            p, seed=seed + i,
            request_id=request_ids[i] if request_ids else None, **kw)
            for i, p in enumerate(prompts)]
        if trace:
            for r in reqs:
                r.trace = dict(trace)
        self._enqueue(reqs)
        return reqs

    def generate(self, prompt, timeout: float = 300.0, **kw) -> list[int]:
        """Blocking convenience wrapper: submit + wait. A timed-out
        wait CANCELS the request (see :meth:`EngineHandle.result`) —
        the slot and its cache blocks come back to the pool instead of
        decoding to ``max_new`` for a client that already gave up."""
        return self.submit(prompt, **kw).result(timeout)

    def cancel(self, request_id: str) -> bool:
        """Cancel one request by id (thread-safe — the
        ``POST /cancel/<request_id>`` path). A QUEUED request fails
        immediately with :class:`RequestCancelledError`; a LIVE (or
        mid-admission) request is retired at the scheduler's next step
        boundary, releasing its slot and block-table refs. Returns
        False when the id is unknown or already retired."""
        with self._cond:
            if self._closed:
                return False
            victim = next((r for r in self._queue
                           if r.request_id == request_id), None)
            if victim is not None:
                self._queue.remove(victim)
                self._g_queue_depth.set(len(self._queue))
            elif request_id in self._inflight_ids:
                self._cancel_ids.add(request_id)
                self._cond.notify_all()
                return True
            else:
                return False
        self._c_cancelled.inc()
        self._account_outcome(victim, "cancelled")
        victim.future.set_exception(RequestCancelledError(
            f"request {request_id} cancelled while queued"))
        return True

    def health(self) -> dict:
        """The watchdog's view (``GET /healthz``): ``live`` while the
        scheduler thread is alive and its heartbeat is younger than
        ``stall_after_s``; ``stalled`` when the thread exists but the
        heartbeat aged out (a wedged dispatch); ``dead`` once the
        thread exited (clean close/drain, or a crash); ``idle`` before
        ``start()``. Reads only cross-thread-safe state — never the
        scheduler-owned fields."""
        now = time.perf_counter()
        with self._cond:
            queued = len(self._queue)
            inflight = len(self._inflight_ids)
            draining = self._draining
            closed = self._closed
        t = self._thread
        age = max(0.0, time.monotonic() - self._heartbeat)
        if t is not None and t.is_alive():
            status = "stalled" if age > self.stall_after_s else "live"
        elif t is None and not closed:
            status = "idle"
        else:
            status = "dead"
        level = self._pressure_level
        return {"status": status,
                "heartbeat_age_s": round(age, 3),
                "stall_after_s": self.stall_after_s,
                "queue_depth": queued, "inflight": inflight,
                "draining": draining,
                # round-18 saturation fields: a live-but-overloaded
                # replica must be VISIBLE as such so the fleet router
                # can demote it to degraded before it mass-sheds
                "queue_age_s": round(self._queue_age_s(now), 3),
                "queue_limit": self.max_queue,
                "pressure": PRESSURE_STATES[level],
                "saturated": level >= 2}

    def set_stall_after(self, stall_after_s: float,
                        settle_timeout_s: float = 2.0) -> None:
        """Retune the watchdog threshold on a LIVE engine (chaos
        harnesses tighten it after XLA-compile warm-up; a supervisor
        could relax it under load). Order matters: the idle park is
        recomputed (the round-15 ``min(0.5, stall/4)`` rule) and the
        scheduler woken FIRST, then this waits (bounded) for a fresh
        heartbeat before the tighter threshold applies — tightening
        against a thread still parked on the OLD wait would flap a
        perfectly healthy idle engine stalled for up to half a
        second."""
        if stall_after_s <= 0:
            raise ValueError(f"stall_after_s must be > 0, got "
                             f"{stall_after_s}")
        self._idle_wait_s = min(0.5, max(0.01, stall_after_s / 4.0))
        with self._cond:
            self._cond.notify_all()
        deadline = time.monotonic() + settle_timeout_s
        while (time.monotonic() - self._heartbeat
               > min(0.1, stall_after_s / 2.0)
               and time.monotonic() < deadline):
            time.sleep(0.005)
        self.stall_after_s = float(stall_after_s)

    def drain(self, timeout_s: float | None = None) -> float:
        """Graceful shutdown: stop admitting (``submit`` raises
        :class:`DrainingError` → HTTP 503 + Retry-After), let the
        scheduler finish every queued and in-flight request under the
        ``timeout_s`` budget (default ``drain_timeout_s``), flush the
        request log, then stop and join the thread. Publishes and
        returns the wall-clock drain time (``serving_drain_ms``).
        Raises :class:`EngineStalledError` — naming the last-heartbeat
        age — if the scheduler never parks; requests the budget
        stranded are failed loudly by the :meth:`close` tail."""
        timeout_s = (self.drain_timeout_s if timeout_s is None
                     else float(timeout_s))
        t0 = time.perf_counter()
        deadline = t0 + timeout_s
        with self._cond:
            self._draining = True
            self._cond.notify_all()
            scheduler_up = (self._thread is not None
                            and self._thread.is_alive())
        if scheduler_up:
            while time.perf_counter() < deadline:
                with self._cond:
                    # _inflight_ids covers admitted AND mid-admission
                    # requests, so queue-empty + inflight-empty means
                    # fully drained (no scheduler-owned field touched)
                    idle = (not self._queue
                            and not self._inflight_ids)
                if idle:
                    break
                time.sleep(0.005)
        try:
            self.close(timeout=max(1.0,
                                   deadline - time.perf_counter()))
        finally:
            drain_ms = round((time.perf_counter() - t0) * 1e3, 3)
            self._g_drain_ms.set(drain_ms)
            if self.metrics_logger is not None:
                flush = getattr(self.metrics_logger, "flush", None)
                if flush is not None:
                    flush()
        return drain_ms

    def _queue_age_s(self, now: float) -> float:
        """Age of the oldest queued request (0.0 when empty) — ONE
        definition for the saturation signal that health(), the
        pressure tick, and the ``serving_queue_age_seconds`` gauge
        all republish, so the three views can never drift. Thread-safe
        (the queue is shared under ``_cond``; the Condition's RLock
        makes nested calls from lock-holding sites safe)."""
        with self._cond:
            oldest = min((r.submitted_at for r in self._queue),
                         default=None)
        return (now - oldest) if oldest is not None else 0.0

    @snapshot_view
    def _retry_after(self) -> float:
        """Retry-After from the measured decode-step EMA × estimated
        steps until a slot frees × the admission waves the current
        queue represents. Reads ``_steps_to_free_hint`` — a scalar the
        scheduler thread refreshes each step — rather than iterating
        ``_live``, which only the scheduler thread may touch (HTTP
        submit threads land here on a full queue)."""
        return round(self._retry.estimate(
            self._steps_to_free_hint, queue_ahead=len(self._queue),
            slots=self.slots), 2)

    # ---- scheduler thread --------------------------------------------
    def start(self) -> "GenerationEngine":
        with self._cond:
            if self._running:
                return self
            self._running = True
        self._thread = threading.Thread(target=self._loop,
                                        name="generation-engine",
                                        daemon=True)
        self._thread.start()
        return self

    def close(self, timeout: float = 10.0) -> None:
        """Fail-fast stop: park the scheduler, then fail every request
        still queued or live (a hung client is worse than a clear
        error — :meth:`drain` is the graceful path that finishes them
        instead). A scheduler thread that does NOT park within
        ``timeout`` raises :class:`EngineStalledError` naming the
        last-heartbeat age — the silent ``join(timeout=10)`` of rounds
        9–13 let the sanitizer's post-join disarm lie about a thread
        that was still running."""
        with self._cond:
            self._running = False
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                # still running: ownership has NOT reverted (sanitizer
                # stays armed, in-flight futures stay unresolved — the
                # wedged thread may yet finish them). Raise before any
                # teardown touches scheduler-owned state.
                age = max(0.0, time.monotonic() - self._heartbeat)
                raise EngineStalledError(
                    f"scheduler thread failed to park within "
                    f"{timeout:.1f}s of close(); last heartbeat "
                    f"{age:.1f}s ago — the engine is wedged "
                    "mid-dispatch (in-flight requests were NOT failed; "
                    "the thread-ownership sanitizer stays armed)")
            self._thread = None
        # the scheduler thread is joined: ownership reverts to the
        # closing thread (disarm the sanitizer, THR01 suppressed below
        # for the same reason — these accesses are post-join teardown).
        self._san_tid = None
        # fail whatever never got scheduled — a hung client is worse
        # than a clear error
        err = RuntimeError("generation engine stopped")
        with self._cond:
            self._c_requests_failed.inc(len(self._queue)
                                        + len(self._live)  # graftlint: disable=THR01
                                        + len(self._prefilling))  # graftlint: disable=THR01
            for req in self._queue:
                self._account_outcome(req, "failed")
                req.future.set_exception(err)
            self._queue.clear()
            self._g_queue_depth.set(0)
            for slot in self._live.values():  # graftlint: disable=THR01
                self._account_outcome(slot.req, "failed")
                slot.req.future.set_exception(err)
            self._live.clear()  # graftlint: disable=THR01
            self._g_live_slots.set(0)
            for slot in self._prefilling.values():  # graftlint: disable=THR01
                self._account_outcome(slot.req, "failed")
                slot.req.future.set_exception(err)
            self._prefilling.clear()  # graftlint: disable=THR01
            self._g_prefilling_slots.set(0)
            self._inflight_ids.clear()
            self._cancel_ids.clear()

    @scheduler_thread
    def _loop(self) -> None:
        self._san_tid = threading.get_ident()
        self._heartbeat = time.monotonic()
        while True:
            self._heartbeat = time.monotonic()
            with self._cond:
                while (self._running and not self._queue
                       and not self._live and not self._prefilling
                       and not self._cancel_ids):
                    self._cond.wait(timeout=self._idle_wait_s)
                    # idle bump: the watchdog must see a parked-but-
                    # healthy scheduler as live, not stalled
                    self._heartbeat = time.monotonic()
                    # idle decay: with nothing queued the saturation
                    # score is 0, and the ladder must walk back to
                    # healthy HERE — an idle engine otherwise reports
                    # its last brownout rung forever and the fleet
                    # router would keep a recovered replica degraded
                    # (Condition's RLock makes the nested acquire in
                    # _update_pressure safe on this thread)
                    if self._pressure_level:
                        self._update_pressure()
                if not self._running:
                    return
            try:
                self._apply_cancellations()
                self._expire_deadlines()
                self._update_pressure()
                self._admit()
                self._prefill_chunk_step()
                if self._live:
                    self._shared_step()
            except Exception as e:
                # a fault that consumed the donated pool poisons every
                # in-flight request (anything recoverable was already
                # quarantined to its one request by _admit/
                # _dispatch_decode; client input cannot raise here —
                # it is fully validated on the submitter's thread):
                # surface it to all waiters INCLUDING a request that
                # died mid-admit, then rebuild the pool — its buffers
                # were donated to the failed call, so reusing the old
                # reference would wedge every later dispatch on a
                # deleted array
                err = RuntimeError(f"scheduler step failed: {e}")
                log.warning("engine-fatal scheduler fault (%d live "
                            "request(s) failed, pool rebuilt): %s",
                            len(self._live) + len(self._prefilling), e)
                if self._flightrec is not None:
                    self._flightrec.incident(
                        "engine_fatal_rebuild",
                        detail=f"{type(e).__name__}: {e}",
                        extra={"live_requests": len(self._live)
                               + len(self._prefilling)})
                with self._cond:
                    if self._admitting is not None:
                        self._account_outcome(self._admitting, "failed")
                        self._admitting.future.set_exception(err)
                        self._admitting = None
                        self._c_requests_failed.inc()
                    self._c_requests_failed.inc(len(self._live)
                                                + len(self._prefilling))
                    for slot in self._live.values():
                        self._account_outcome(slot.req, "failed")
                        slot.req.future.set_exception(err)
                    for slot in self._prefilling.values():
                        self._account_outcome(slot.req, "failed")
                        slot.req.future.set_exception(err)
                    self._live.clear()
                    self._prefilling.clear()
                    self._g_live_slots.set(0)
                    self._g_prefilling_slots.set(0)
                    self._free = list(range(self.slots))[::-1]
                    self._inflight_ids.clear()
                    self._cancel_ids.clear()
                self._last_dispatch_t = 0.0
                self._pool = self.sw.make_pool()
                if self.paged:
                    # the rebuilt pool is empty: every table entry and
                    # cached prefix names bytes that no longer exist
                    # (hit/miss counters live in the engine registry,
                    # so the rebuilt PrefixCache keeps counting where
                    # the dead one stopped)
                    self._tables[:] = 0
                    self.blocks = BlockPool(self.num_blocks)
                    if self.prefix_cache is not None:
                        self.prefix_cache = PrefixCache(
                            self.blocks, self.block_size,
                            registry=self.registry)

    @scheduler_thread
    def _apply_cancellations(self) -> None:
        """Honor pending :meth:`cancel` calls at the step boundary:
        every live slot whose request id was cancelled retires NOW,
        releasing its slot and block-table refs (queued cancellations
        were already failed on the canceller's thread)."""
        with self._cond:
            if not self._cancel_ids:
                return
            ids = set(self._cancel_ids)
        for slot in (list(self._live.values())
                     + list(self._prefilling.values())):
            rid = slot.req.request_id
            if rid in ids:
                self._fail_slot(slot, RequestCancelledError(
                    f"request {rid} cancelled after "
                    f"{len(slot.tokens)} token(s)"),
                    counter=self._c_cancelled)
        # a cancel that landed while its request was MID-ADMISSION can
        # find the request back in the queue: block-pressure deferral
        # re-queues at the head (dropping the in-flight id), and the
        # queued-cancel fast path in cancel() already ran — without
        # this sweep the accepted cancellation would be silently lost
        # and the request later admitted, the exact leak cancel()
        # promised to prevent
        requeued: list[GenRequest] = []
        with self._cond:
            for r in list(self._queue):
                if r.request_id in ids:
                    self._queue.remove(r)
                    requeued.append(r)
            if requeued:
                self._g_queue_depth.set(len(self._queue))
        for r in requeued:
            self._c_cancelled.inc()
            self._account_outcome(r, "cancelled")
            r.future.set_exception(RequestCancelledError(
                f"request {r.request_id} cancelled while re-queued "
                "under block pressure"))
        with self._cond:
            # keep only ids still mid-admission (they land in _live
            # next boundary and retire then); everything else — just
            # handled, or already retired — is done
            self._cancel_ids &= self._inflight_ids

    @scheduler_thread
    def _expire_deadlines(self) -> None:
        """Enforce per-request ``deadline_ms`` between steps: expired
        QUEUED requests fail without ever taking a slot, expired LIVE
        slots retire immediately (blocks released) — a deadline is a
        promise about resources, not just latency."""
        now = time.perf_counter()
        expired: list[GenRequest] = []
        with self._cond:
            for r in list(self._queue):
                if r.deadline_t and now >= r.deadline_t:
                    self._queue.remove(r)
                    expired.append(r)
            if expired:
                self._g_queue_depth.set(len(self._queue))
        for r in expired:
            self._c_deadline.inc()
            self._account_outcome(r, "expired")
            r.future.set_exception(DeadlineExceededError(
                f"request {r.request_id} missed its {r.deadline_ms} ms "
                "deadline while queued (never admitted)"))
        for slot in (list(self._live.values())
                     + list(self._prefilling.values())):
            req = slot.req
            if req.deadline_t and now >= req.deadline_t:
                self._fail_slot(slot, DeadlineExceededError(
                    f"request {req.request_id} missed its "
                    f"{req.deadline_ms} ms deadline after "
                    f"{len(slot.tokens)} token(s)"),
                    counter=self._c_deadline)

    @scheduler_thread
    def _admit(self) -> None:
        """Drain the queue into free slots. Runs between shared steps —
        admission joins mid-flight. Slab path: one prefill dispatch per
        admission. Paged path: prefix-cache hits mount existing blocks
        and teacher-force the uncached suffix through the SHARED step
        (zero prefill dispatches); misses allocate a block run and run
        the paged prefill. Block pressure pushes the request back to
        the queue head — retirement (or cache eviction) clears it.

        Quarantine (round 14): an admission/prefill failure that left
        the donated pool intact fails ONLY the offending request
        (:meth:`_fail_admission`); only a pool-consuming fault
        escalates to the loop's engine-fatal handler."""
        while True:
            with self._cond:
                if not self._queue or not self._free:
                    return
                # ordered admission (round 18): class, then earliest
                # deadline, then FIFO — with aging so best_effort is
                # served within a bounded wait. Priority-less traffic
                # (every request at the default class, no deadlines)
                # selects index 0: exactly the old popleft.
                i = select_index(self._queue, time.perf_counter(),
                                 aging_s=self.priority_aging_s)
                req = self._queue[i]
                del self._queue[i]
                index = self._free.pop()
                self._g_queue_depth.set(len(self._queue))
                self._admitting = req
                self._inflight_ids.add(req.request_id)
            req.t_admit = time.perf_counter()
            # the slot lane shows the tail of the wait spent waiting
            # for THIS slot (lanes must tile under reuse); the full
            # wait rides the args and the timings breakdown
            add_span("queue_wait",
                     max(req.submitted_at, self._slot_freed_t[index]),
                     req.t_admit, process=self.process,
                     lane=f"slot{index}",
                     request_id=req.request_id,
                     queued_ms=round((req.t_admit - req.submitted_at)
                                     * 1e3, 3), **req.trace)
            try:
                faults.inject("engine.admit", detail=req.request_id)
                if self.paged:
                    admitted = self._admit_paged(req, index)
                else:
                    self._admit_slab(req, index)
                    admitted = True
            except Exception as e:
                if not self._pool_alive():
                    raise          # donated pool consumed: engine-fatal
                self._fail_admission(req, index, e)
                admitted = True                     # slot already freed
            with self._cond:
                self._admitting = None
                self._g_live_slots.set(len(self._live))
                if not admitted:
                    return

    @scheduler_thread
    def _pool_alive(self) -> bool:
        """True while the engine's pool buffers are still usable. Both
        stepwise programs DONATE the pool; a dispatch that failed
        before consuming it (a seam injection, host-side validation)
        leaves every buffer intact — the quarantine protocol's
        recoverable case — while a failure that deleted them forces
        the engine-fatal rebuild."""
        for v in self._pool.values():
            deleted = getattr(v, "is_deleted", None)
            if deleted is not None and deleted():
                return False
        return True

    @scheduler_thread
    def _fail_admission(self, req: GenRequest, index: int,
                        err: Exception) -> None:
        """Quarantine one failed admission: the offending request fails
        loudly, its slot returns to the free list, and every neighbor
        keeps decoding — one bad request must never be engine-fatal."""
        log.warning("admission of request %s failed (quarantined): %s",
                    req.request_id, err)
        with self.registry.atomic():
            self._c_admissions.inc()
            self._c_requests_failed.inc()
            if self.paged and self.prefix_cache is not None:
                # an admission outcome counts hit or miss exactly once;
                # a failed admission never mounted cached blocks
                self.prefix_cache.record_miss()
        with self._cond:
            self._free.append(index)
            self._inflight_ids.discard(req.request_id)
        self._slot_freed_t[index] = time.perf_counter()
        self._account_outcome(req, "failed")
        req.future.set_exception(
            err if isinstance(err, BlocksExhaustedError)
            else PoisonedRequestError(
                f"request {req.request_id} failed at admission "
                f"({type(err).__name__}: {err}); its neighbors were "
                "not disturbed"))

    def _drafter_for(self, req: GenRequest) -> NgramDrafter | None:
        """The per-request drafter, or None when this request cannot
        speculate: engine spec off, request opted out (spec_tokens=0),
        or SAMPLED — the exact rejection rule is a greedy contract
        (token == argmax); a sampled request always dispatches at lane
        width 1 with its one-Gumbel-per-token host stream untouched."""
        if not self._verify_width or req.temperature > 0.0 \
                or req.spec_tokens == 0:
            return None
        return NgramDrafter([int(t) for t in req.prompt])

    @scheduler_thread
    def _admit_slab(self, req: GenRequest, index: int) -> None:
        ids = np.zeros((1, self.prompt_len), np.int32)
        mask = np.zeros((1, self.prompt_len), np.int32)
        p = req.prompt.size
        ids[0, :p] = req.prompt
        mask[0, :p] = 1
        with span("prefill", process=self.process, lane=f"slot{index}",
                  request_id=req.request_id, prompt_tokens=p,
                  **req.trace):
            faults.inject("engine.prefill", detail=req.request_id)
            out = self.sw.prefill({
                "input_ids": ids, "prompt_mask": mask,
                "slot": np.int32(index), **self._pool})
            # materialize BEFORE adopting the returned pool: on an
            # async backend a device-side fault surfaces at this block,
            # and self._pool must still name the donated (now deleted)
            # inputs so _pool_alive() escalates to the engine-fatal
            # rebuild instead of quarantining over a poisoned pool
            logits0 = np.asarray(out["logits"])[0]
            pad0 = int(np.asarray(out["pad"])[0])
            self._pool = {k: v for k, v in out.items()
                          if k.startswith("cache_")}
        with self.registry.atomic():
            self._c_admissions.inc()
            self._c_prefills.inc()
        self._admit_counter += 1
        slot = _Slot(req, index, pad=pad0,
                     pos=self.prompt_len, rng=req.sampler(),
                     seq=self._admit_counter)
        slot.t_prefill_done = time.perf_counter()
        tok = self._pick(slot, logits0)
        self._emit(slot, tok)

    @scheduler_thread
    def _admit_paged(self, req: GenRequest, index: int) -> bool:
        """Paged admission; returns False when block pressure defers
        the request (re-queued at the head, slot index returned)."""
        tokens = np.asarray(req.prompt, np.int32)
        p = int(tokens.size)
        # record=False: this probe repeats every step while the request
        # is deferred under block pressure — hits/misses are counted
        # below, exactly once per ADMISSION OUTCOME
        n_hit, hit_blocks = ((self.prefix_cache.lookup(tokens,
                                                       record=False))
                             if self.prefix_cache is not None
                             else (0, ()))
        if n_hit:
            # Cache hit: mount the cached blocks by reference and feed
            # the remaining KNOWN tokens through the shared decode step
            # (teacher-forced). An EXACT whole-prompt hit re-feeds only
            # the last prompt token — its logits are the first sample
            # point, and its write copy-on-writes the shared tail block.
            start = n_hit - 1 if n_hit == p else n_hit
            with span("prefill", process=self.process,
                      lane=f"slot{index}",
                      request_id=req.request_id, prompt_tokens=p,
                      cached_tokens=start, **req.trace):
                self.blocks.retain(hit_blocks)
                self._tables[index, :len(hit_blocks)] = hit_blocks
            with self.registry.atomic():
                self._c_admissions.inc()
                self.prefix_cache.record_hit()
                self._c_tokens_saved.inc(start)
            self._admit_counter += 1
            slot = _Slot(req, index, pad=0, pos=start,
                         rng=req.sampler(), seq=self._admit_counter)
            slot.drafter = self._drafter_for(req)
            slot.t_prefill_done = time.perf_counter()
            slot.last_tok = int(tokens[start])
            slot.forced = [int(t) for t in tokens[start + 1:]]
            if n_hit < p:
                # once the suffix is teacher-forced in, cache the FULL
                # prompt so an identical repeat exact-hits (the suffix
                # blocks' bytes are decode-computed — same token-level
                # parity contract as the forcing itself)
                slot.pending_insert = tokens
            self._live[index] = slot
            return True
        # Cold: allocate the prompt's block run (evicting LRU cache
        # entries under pressure) and run the paged prefill program.
        needed = -(-p // self.block_size)
        try:
            if self.blocks.free_count < needed \
                    and self.prefix_cache is not None:
                self.prefix_cache.evict(needed)
            run = self.blocks.alloc(needed)
        except BlocksExhaustedError as e:
            if self._live or self._prefilling:
                # retirement will free blocks — try again next boundary
                # (the deferral is the pressure ladder's
                # block-starvation signal: demand waiting on a pool
                # that cannot serve it)
                self._block_deferred = True
                with self._cond:
                    self._queue.appendleft(req)
                    self._g_queue_depth.set(len(self._queue))
                    self._free.append(index)
                    self._inflight_ids.discard(req.request_id)
                self._slot_freed_t[index] = time.perf_counter()
                return False
            # nothing live, cache already evicted: the pool simply
            # cannot hold this prompt — fail IT, keep serving
            self._fail_admission(req, index, BlocksExhaustedError(
                f"prompt of {p} tokens needs {needed} cache blocks but "
                f"the pool cannot free them: {e}"))
            return True
        if self.prefill_chunk_tokens:
            # chunked-prefill admission: the block run is secured and
            # the slot PARKS — no prefill dispatch here; the scheduler
            # feeds one chunk per iteration (_prefill_chunk_step),
            # interleaved with the shared decode step, and the final
            # chunk's logits become the first sample point
            self._tables[index, :needed] = run
            with self.registry.atomic():
                self._c_admissions.inc()
                if self.prefix_cache is not None:
                    self.prefix_cache.record_miss()
            self._admit_counter += 1
            slot = _Slot(req, index, pad=0, pos=0, rng=req.sampler(),
                         seq=self._admit_counter)
            slot.drafter = self._drafter_for(req)
            self._prefilling[index] = slot
            self._g_prefilling_slots.set(len(self._prefilling))
            return True
        table_row = np.zeros((self.prompt_blocks,), np.int32)
        table_row[:needed] = run
        ids = np.zeros((1, self.prompt_len), np.int32)
        mask = np.zeros((1, self.prompt_len), np.int32)
        ids[0, :p] = tokens
        mask[0, :p] = 1
        try:
            with span("prefill", process=self.process,
                      lane=f"slot{index}",
                      request_id=req.request_id, prompt_tokens=p,
                      **req.trace):
                faults.inject("engine.prefill", detail=req.request_id)
                out = self.sw.prefill({
                    "input_ids": ids, "prompt_mask": mask,
                    "table_row": table_row, **self._pool})
                # materialize BEFORE adopting the returned pool (see
                # _admit_slab): an async device fault must leave
                # self._pool naming the donated inputs so the outer
                # handler's _pool_alive() probe escalates correctly
                logits0 = np.asarray(out["logits"])[0]
                self._pool = {k: v for k, v in out.items()
                              if k.startswith("cache_")}
        except Exception:
            # quarantine path (the outer _admit handler fails the
            # request): the block run allocated above must go back to
            # the pool first — a failed admission must not leak HBM.
            # A pool-consuming fault still escalates there.
            self.blocks.release(run)
            raise
        with self.registry.atomic():
            self._c_admissions.inc()
            self._c_prefills.inc()
            if self.prefix_cache is not None:
                self.prefix_cache.record_miss()
        self._tables[index, :needed] = run
        if self.prefix_cache is not None:
            self.prefix_cache.insert(tokens, run)
        self._admit_counter += 1
        slot = _Slot(req, index, pad=0, pos=p, rng=req.sampler(),
                     seq=self._admit_counter)
        slot.drafter = self._drafter_for(req)
        slot.t_prefill_done = time.perf_counter()
        tok = self._pick(slot, logits0)
        self._emit(slot, tok)
        return True

    @scheduler_thread
    def _prefill_chunk_step(self) -> None:
        """Dispatch ONE chunked-prefill chunk for the oldest parked
        slot (admission order) — at most ``prefill_chunk_tokens``
        prompt tokens per scheduler iteration, so the shared decode
        step between chunks can never be stalled longer than one
        chunk's dispatch. The final chunk's logits are the request's
        first sample point: the slot leaves ``_prefilling``, its
        prompt enters the prefix cache (the cold path's insert,
        deferred to when the bytes are actually resident), and
        :meth:`_emit` takes it live. A chunk failure that left the
        donated pool intact quarantines THIS request alone (blocks
        released, neighbors undisturbed — the prefill protocol); a
        pool-consuming fault re-raises into the engine-fatal
        handler."""
        if not self._prefilling:
            return
        slot = min(self._prefilling.values(),
                   key=lambda s: s.admit_seq)
        req = slot.req
        tokens = np.asarray(req.prompt, np.int32)
        p = int(tokens.size)
        start = slot.chunk_done
        n = min(self.prefill_chunk_tokens, p - start)
        cw = self._chunk_width
        bs = self.block_size
        ids = np.zeros((1, cw), np.int32)
        mask = np.zeros((1, cw), np.int32)
        ids[0, :n] = tokens[start:start + n]
        mask[0, :n] = 1
        # write targets: the chunk's whole blocks out of this slot's
        # table row; lanes past the prompt's allocated run write the
        # reserved null block (never read — the paged convention)
        needed = -(-p // bs)
        row = self._tables[slot.index]
        cb = np.zeros((cw // bs,), np.int32)
        for j in range(cw // bs):
            bi = start // bs + j
            if bi < needed:
                cb[j] = row[bi]
        t0 = time.perf_counter()
        try:
            with span("prefill_chunk", process=self.process,
                      lane=f"slot{slot.index}",
                      request_id=req.request_id, start=start,
                      chunk_tokens=n, prompt_tokens=p, **req.trace):
                faults.inject("engine.prefill",
                              detail=f"{req.request_id}@{start}")
                out = self.sw.prefill_chunk({
                    "input_ids": ids, "chunk_mask": mask,
                    "start": np.int32(start),
                    "table_row": np.ascontiguousarray(
                        row[:self.prompt_blocks]),
                    "chunk_blocks": cb, **self._pool})
                # materialize BEFORE adopting the returned pool (the
                # _admit_slab convention): an async device fault must
                # leave self._pool naming the donated inputs so
                # _pool_alive() escalates correctly
                logits0 = np.asarray(out["logits"])[0]
                self._pool = {k: v for k, v in out.items()
                              if k.startswith("cache_")}
        except Exception as e:
            if not self._pool_alive():
                raise          # donated pool consumed: engine-fatal
            log.warning("chunked prefill of request %s failed at "
                        "token %d (quarantined): %s", req.request_id,
                        start, e)
            self._fail_slot(slot, PoisonedRequestError(
                f"request {req.request_id} failed at prefill chunk "
                f"starting token {start} ({type(e).__name__}: {e}); "
                "its neighbors were not disturbed"))
            return
        # the SPLIT estimator: chunk wall time feeds the prefill EMA,
        # never the decode-step EMA Retry-After reads
        self._retry.observe_prefill(time.perf_counter() - t0)
        self._c_prefill_chunks.inc()
        slot.chunk_done = start + n
        if slot.chunk_done < p:
            return
        # prompt fully resident: same tail as the monolithic cold path
        slot.pos = p
        slot.t_prefill_done = time.perf_counter()
        del self._prefilling[slot.index]
        self._g_prefilling_slots.set(len(self._prefilling))
        if self.prefix_cache is not None:
            self.prefix_cache.insert(
                tokens, [int(b) for b in row[:needed]])
        tok = self._pick(slot, logits0)
        self._emit(slot, tok)
        with self._cond:
            self._g_live_slots.set(len(self._live))

    @scheduler_thread
    def _update_pressure(self) -> None:
        """One brownout-ladder tick: refresh the queue-age gauge, shed
        queued requests whose deadline is already infeasible at the
        measured service rate (429 now beats a 504 after wasted queue
        time), recompute the pressure level from the saturation score
        (queue depth + queue age + the block-starvation deferral EMA,
        with hysteresis), and — at ``interactive_only`` — shed the queued
        non-interactive backlog. ``shed_policy="off"`` keeps only the
        gauge refresh: no ladder, no feasibility shed."""
        now = time.perf_counter()
        with self._cond:
            depth = len(self._queue)
        age = self._queue_age_s(now)
        self._g_queue_age.set(round(age, 4))
        if self.shed_policy != "auto":
            return
        self._shed_infeasible(now)
        self._defer_ema += 0.2 * (
            (1.0 if self._block_deferred else 0.0) - self._defer_ema)
        self._block_deferred = False
        score = max(depth / max(1, self.max_queue),
                    age / self.pressure_age_budget_s,
                    self._defer_ema)
        level = compute_pressure_level(self._pressure_level, score)
        if level != self._pressure_level:
            log.warning("pressure %s -> %s (score %.2f: queue %d/%d, "
                        "age %.2fs)", PRESSURE_STATES[
                            self._pressure_level],
                        PRESSURE_STATES[level], score, depth,
                        self.max_queue, age)
            self._c_pressure_transitions.inc()
            if self._flightrec is not None:
                self._flightrec.incident(
                    "pressure_transition",
                    detail=f"{PRESSURE_STATES[self._pressure_level]} "
                           f"-> {PRESSURE_STATES[level]}",
                    extra={"score": round(score, 3),
                           "queue_depth": depth,
                           "queue_age_s": round(age, 3)})
            self._pressure_level = level
        self._g_pressure_level.set(level)
        if level >= 3:
            # interactive_only: the queued non-interactive backlog is
            # shed too — it would only age into deadline expiry while
            # starving the interactive class the rung protects
            self._shed_queued(
                lambda r: r.priority != "interactive",
                reason="pressure interactive_only")

    @scheduler_thread
    def _shed_infeasible(self, now: float) -> None:
        """Shed queued requests whose ``deadline_ms`` can no longer be
        met at the MEASURED service rate (decode-step + prefill-chunk
        EMAs, each work class priced by its own component). Never acts
        before the estimator has a real decode signal — no signal
        beats a fake one.

        Pricing is the WORST CASE (``max_new`` row-steps; the engine
        cannot know whether a generation will EOS early) — the only
        estimate that is sound against the deadline promise: a request
        priced optimistically would be admitted, hold a slot, and
        still 504 whenever EOS doesn't come. Deadline-carrying clients
        that rely on early stopping should send a realistic
        ``max_new`` cap with the deadline."""
        if not self._retry.seeded:
            return
        budget = self.prefill_chunk_tokens

        def infeasible(r: GenRequest) -> bool:
            if not r.deadline_t:
                return False
            chunks = (-(-int(r.prompt.size) // budget) if budget
                      else 0)
            need = self._retry.time_for(r.max_new,
                                        prefill_chunks=chunks)
            return need is not None and now + need > r.deadline_t

        self._shed_queued(infeasible, reason="deadline infeasible",
                          infeasible_counter=True)

    @scheduler_thread
    def _shed_queued(self, pred, *, reason: str,
                     infeasible_counter: bool = False) -> None:
        """Remove queued requests matching ``pred`` and fail them with
        :class:`ShedError` (429 + measured Retry-After) — shedding
        BEFORE a slot or more queue time is wasted on them."""
        with self._cond:
            victims = [r for r in self._queue if pred(r)]
            for r in victims:
                self._queue.remove(r)
            if victims:
                self._g_queue_depth.set(len(self._queue))
        if not victims:
            return
        ra = self._retry_after()
        with self.registry.atomic():
            for r in victims:
                self._c_shed.inc()
                self._c_shed_class[r.priority].inc()
                if infeasible_counter:
                    self._c_shed_infeasible.inc()
                self._account_outcome(r, "shed")
        for r in victims:
            r.future.set_exception(ShedError(
                f"request {r.request_id} shed while queued "
                f"({reason}) — retry after the hint",
                retry_after=ra))

    @scheduler_thread
    def _release_slot_blocks(self, index: int) -> None:
        """Retirement/failure: drop this slot's table references (a
        block shared with the prefix cache or another slot survives —
        freed only at its LAST release) and reset the row to the null
        block."""
        row = self._tables[index]
        ids = [int(b) for b in row if b]
        if ids:
            self.blocks.release(ids)
        row[:] = 0

    @scheduler_thread
    def _fail_slot(self, slot: _Slot, err: Exception,
                   counter=None) -> None:
        """Retire ONE live (or mid-chunked-prefill) request with
        ``err`` — block exhaustion, quarantine eviction, cancellation,
        or deadline expiry — without disturbing its neighbors: table
        refs released (paged), slot freed, THEN the future resolves.
        ``counter`` picks which retirement counter advances (default:
        requests_failed)."""
        if self.paged:
            self._release_slot_blocks(slot.index)
        if slot.index in self._prefilling \
                and self._prefilling[slot.index] is slot:
            del self._prefilling[slot.index]
            self._g_prefilling_slots.set(len(self._prefilling))
        else:
            del self._live[slot.index]
            if not self._live:
                # nobody decodes across the coming gap: the stall
                # stamp must not survive into the next dispatch as a
                # spurious giant serving_decode_stall_seconds sample
                self._last_dispatch_t = 0.0
        (counter if counter is not None
         else self._c_requests_failed).inc()
        self._account_outcome(
            slot.req,
            "expired" if isinstance(err, DeadlineExceededError)
            else "cancelled" if isinstance(err, RequestCancelledError)
            else "shed" if isinstance(err, ShedError)
            else "failed",
            tokens=len(slot.tokens))
        with self._cond:
            self._free.append(slot.index)
            self._g_live_slots.set(len(self._live))
            self._inflight_ids.discard(slot.req.request_id)
        self._slot_freed_t[slot.index] = time.perf_counter()
        slot.req.future.set_exception(err)

    @scheduler_thread
    def _ensure_write_block(self, slot: _Slot, n: int = 1) -> None:
        """Before a decode step writes at ``slot.pos`` (or a verify
        dispatch writes the span ``pos..pos+n-1``): allocate-on-write
        when a target table entry is still the null block, and
        copy-on-write when a target block is shared (prefix cache or
        another slot still references it) — a divergence must never
        mutate bytes someone else reads. Only the FIRST block of a
        verify span can be shared (anything past the slot's own write
        frontier was never cached), but every block gets the same
        check — the invariant, not the current topology, is what the
        code states."""
        bs = self.block_size
        for bi in range(slot.pos // bs, (slot.pos + n - 1) // bs + 1):
            pb = int(self._tables[slot.index, bi])
            if pb == 0:
                if self.blocks.free_count < 1 \
                        and self.prefix_cache is not None:
                    self.prefix_cache.evict(1)
                self._tables[slot.index, bi] = self.blocks.alloc(1)[0]
            elif self.blocks.refcount(pb) > 1:
                # cow spans live on the scheduler lane (they interleave
                # with the slot's long decode window, and slot lanes
                # must stay non-overlapping); the request id keeps
                # correlation
                with span("cow_copy", process=self.process,
                          lane="scheduler",
                          request_id=slot.req.request_id,
                          slot=slot.index, block=pb,
                          **slot.req.trace):
                    if self.blocks.free_count < 1 \
                            and self.prefix_cache is not None:
                        self.prefix_cache.evict(1)
                    nb = self.blocks.alloc(1)[0]
                    self._pool = self._copy_block(self._pool, pb, nb)
                    self._tables[slot.index, bi] = nb
                    self.blocks.release([pb])
                self._c_cow.inc()

    @scheduler_thread
    def _release_trailing_blocks(self, slot: _Slot,
                                 span_end: int) -> None:
        """After a draft rejection rewound ``slot.pos``: any block the
        verify span secured PAST the next write position holds only
        rejected-lane bytes nothing will ever read — its (fresh,
        refcount-1) ref returns to the pool and the table entry goes
        back to the null block. The block containing the next write
        position is kept: the next dispatch writes into it. No-op when
        the rejection stayed inside one block — the left-aligned paged
        layout means a rewind releases nothing unless the span crossed
        a block boundary."""
        bs = self.block_size
        row = self._tables[slot.index]
        last = min(span_end // bs, row.size - 1)
        for bi in range(slot.pos // bs + 1, last + 1):
            pb = int(row[bi])
            if pb:
                self.blocks.release([pb])
                row[bi] = 0

    def _pick(self, slot: _Slot, logits: np.ndarray) -> int:
        """Per-request sampling on the host side of the step boundary
        (greedy argmax mirrors the monolithic program's jnp.argmax —
        first index on ties)."""
        req = slot.req
        if req.temperature <= 0.0:
            return int(np.argmax(logits))
        scaled = filter_logits_np(logits.astype(np.float64)
                                  / req.temperature,
                                  req.top_k, req.top_p)
        g = slot.rng.gumbel(size=scaled.shape)
        return int(np.argmax(scaled + g))

    @scheduler_thread
    def _emit(self, slot: _Slot, tok: int) -> None:
        """Record one sampled/accepted token; retire or keep the slot
        live. Runs once per token in emission order on BOTH paths —
        normal decode and the spec accept loop — so EOS, ``max_new``
        and ``stop_sequences`` truncate at exactly the same boundary
        with speculation on or off."""
        slot.emitted += 1
        slot.tokens.append(tok)
        slot.last_tok = tok
        self._c_tokens_out.inc()
        if slot.drafter is not None:
            slot.drafter.extend(tok)
        req = slot.req
        if slot.emitted == 1:
            req.t_first = time.perf_counter()
        stopped = False
        for ss in req.stop_sequences:
            n = len(ss)
            if len(slot.tokens) >= n and slot.tokens[-n:] == ss:
                # truncate AT the boundary: the match itself never
                # reaches the client (checked after every token, so a
                # match is always a suffix of the emitted stream)
                del slot.tokens[-n:]
                stopped = True
                break
        done = (stopped or slot.emitted >= req.max_new
                or (req.eos_id is not None and tok == req.eos_id))
        if done:
            # pad to max_new after EOS/stop — byte-identical to the
            # monolithic while_loop's preallocated pad_id buffer
            toks = slot.tokens + [req.pad_id] * (req.max_new
                                                 - len(slot.tokens))
            self._retire(slot, toks)
        else:
            self._live[slot.index] = slot

    def _account_outcome(self, req: GenRequest, outcome: str, *,
                         good: bool = False, tokens: int = 0) -> None:
        """Per-request terminal accounting, EXACTLY ONCE per request
        (the ``req.accounted`` latch — several failure paths can race
        toward the same request): the per-class + aggregate SLO
        served/good counters, goodput tokens, and — for non-``ok``
        outcomes — the request-log event (the ``ok`` event is emitted
        by :meth:`_retire` with the full timings breakdown, AFTER the
        future resolves). Callable from any thread: touches only the
        request, the registry, and the JSONL sink."""
        if req.accounted:
            return
        req.accounted = True
        with self.registry.atomic():
            self._c_slo_served_all.inc()
            self._c_slo_served[req.priority].inc()
            if good:
                self._c_slo_good_all.inc()
                self._c_slo_good[req.priority].inc()
                if tokens:
                    self._c_goodput_tokens.inc(tokens)
        if outcome != "ok" and self.metrics_logger is not None:
            self.metrics_logger.log({
                "event": "generate",
                "request_id": req.request_id,
                "outcome": outcome,
                "priority": req.priority,
                "deadline_ms": req.deadline_ms,
                "slo_good": False,
                "tokens": int(tokens),
                "total_ms": round((time.perf_counter()
                                   - req.submitted_at) * 1e3, 3),
            })

    @scheduler_thread
    def _retire(self, slot: _Slot, toks: list[int]) -> None:
        """Retirement: timings breakdown, spans, counters, slot free,
        and ONLY THEN the future resolution (a client that wakes on the
        future must find ``req.timings`` already set)."""
        req = slot.req
        t_ret = time.perf_counter()
        lane = f"slot{slot.index}"
        # the slot lane tiles: [queue_wait][prefill][forced?][decode][retire]
        if slot.t_forced_done > slot.t_prefill_done:
            add_span("forced_suffix", slot.t_prefill_done,
                     slot.t_forced_done, process=self.process,
                     lane=lane, request_id=req.request_id, **req.trace)
        if req.t_first:
            add_span("decode", max(req.t_first, slot.t_forced_done,
                                   slot.t_prefill_done), t_ret,
                     process=self.process, lane=lane,
                     request_id=req.request_id,
                     tokens=len(slot.tokens), **req.trace)
        # good = retired normally AND inside its own deadline (no
        # deadline = always good): THE definition the SLO counters,
        # the goodput tps, and the request-log replay all share —
        # recorded explicitly (slo_good) so offline consumers never
        # re-derive it from rounded millisecond fields
        good = not req.deadline_t or t_ret <= req.deadline_t
        req.timings = {
            "request_id": req.request_id,
            "queue_ms": round((req.t_admit - req.submitted_at) * 1e3, 3),
            "prefill_ms": round((slot.t_prefill_done - req.t_admit)
                                * 1e3, 3),
            "decode_ms": round((t_ret - max(slot.t_prefill_done,
                                            req.t_first or 0.0))
                               * 1e3, 3),
            "total_ms": round((t_ret - req.submitted_at) * 1e3, 3),
            "tokens": len(slot.tokens),
            # draft tokens the verify dispatches accepted for THIS
            # request (0 with speculation off) — the per-request view
            # of serving_spec_accepted_total
            "spec_accepted": slot.spec_accepted,
            # request-log completeness (round 19): the JSONL event is
            # the ground truth servetop and the SLO counters reconcile
            # against, so it must carry the class, the budget, and the
            # outcome — not just the phase timings
            "priority": req.priority,
            "deadline_ms": req.deadline_ms,
            "outcome": "ok",
            "slo_good": good,
        }
        with span("retire", process=self.process, lane=lane,
                  request_id=req.request_id, **req.trace):
            if self.paged:
                self._release_slot_blocks(slot.index)
            with self._cond:
                self._free.append(slot.index)
                self._g_live_slots.set(len(self._live))
                self._inflight_ids.discard(req.request_id)
        self._slot_freed_t[slot.index] = time.perf_counter()
        # counters BEFORE the future resolves: a client waking on
        # result() must find requests_done already advanced (tests and
        # the /stats-vs-/metrics quiesced-equality check read exactly
        # that way); the µs-scale registry block is not what the
        # closed-loop client's turnaround feels — the file-I/O request
        # log below is, so only THAT lands after set_result
        with self.registry.atomic():
            self._c_requests_done.inc()
            self._h_latency.observe(t_ret - req.submitted_at)
            self._h_class_latency[req.priority].observe(
                t_ret - req.submitted_at)
            self._h_queue_wait.observe(req.t_admit - req.submitted_at)
            self._h_prefill.observe(slot.t_prefill_done - req.t_admit)
            self._h_decode.observe(t_ret - max(slot.t_prefill_done,
                                               req.t_first or 0.0))
            self._account_outcome(req, "ok", good=good,
                                  tokens=len(slot.tokens))
        self._latencies.append(t_ret - req.submitted_at)
        req.future.set_result(toks)
        if self.metrics_logger is not None:
            self.metrics_logger.log({"event": "generate", **req.timings})

    @scheduler_thread
    def _build_step_feats(self) -> dict:
        """The shared decode step's operand dict for the CURRENT live
        set — rebuilt after a quarantine eviction so survivors
        re-dispatch with the dead row marked not-alive."""
        tok = np.zeros((self.slots,), np.int32)
        pos = np.zeros((self.slots,), np.int32)
        pad = np.zeros((self.slots,), np.int32)
        alive = np.zeros((self.slots,), np.int32)
        for i, s in self._live.items():
            tok[i] = s.last_tok
            pos[i] = s.pos
            pad[i] = s.pad
            alive[i] = 1
        feats = {"tok": tok, "pos": pos, "pad": pad, "alive": alive,
                 **self._pool}
        if self.paged:
            feats["block_tables"] = self._tables
        return feats

    @scheduler_thread
    def _build_verify_feats(self) -> dict:
        """The K-token verify dispatch's operand dict: lane 0 of every
        live row is its anchor token (exactly what the normal step
        would dispatch), lanes 1..len(draft) its draft proposals, and
        ``n_tok`` gates the write span per row — draftless, sampled and
        teacher-forced slots ride the same dispatch at width 1.
        Rebuilt after a quarantine eviction, same as
        :meth:`_build_step_feats` (surviving rows keep their drafts)."""
        kk = self._verify_width
        tok = np.zeros((self.slots, kk), np.int32)
        pos = np.zeros((self.slots,), np.int32)
        pad = np.zeros((self.slots,), np.int32)
        alive = np.zeros((self.slots,), np.int32)
        n_tok = np.ones((self.slots,), np.int32)
        for i, s in self._live.items():
            tok[i, 0] = s.last_tok
            if s.draft:
                tok[i, 1:1 + len(s.draft)] = s.draft
                n_tok[i] = 1 + len(s.draft)
            pos[i] = s.pos
            pad[i] = s.pad
            alive[i] = 1
        return {"tok": tok, "pos": pos, "pad": pad, "alive": alive,
                "n_tok": n_tok, "block_tables": self._tables,
                **self._pool}

    @scheduler_thread
    def _dispatch_decode(self, feats: dict, *, call=None,
                         rebuild=None,
                         span_name: str = "decode_step"
                         ) -> np.ndarray | None:
        """One shared dispatch (normal decode step, or — ``call``/
        ``rebuild`` overridden — the K-token verify program) under the
        bounded re-dispatch protocol: a first failure that left the
        donated pool intact is retried once (transient faults heal
        invisibly — same greedy bytes, one extra dispatch); a REPEAT
        failure evicts the newest-admitted slot (fails it loudly) and
        re-dispatches the survivors, whose rows are computationally
        independent — their greedy bytes match an undisturbed run.
        Bounded: at most one retry plus one eviction per remaining
        live slot. Returns the logits, or None when eviction emptied
        the batch. A pool-consuming failure re-raises into the
        engine-fatal handler. Both programs share ONE protocol and ONE
        ``engine.decode_step`` fault seam — a verify dispatch is
        quarantined exactly like a normal one (eviction releases the
        victim's whole span; survivors' drafts ride the rebuild)."""
        if call is None:
            call = self.sw.decode
        if rebuild is None:
            rebuild = self._build_step_feats
        reg = faults.active()
        idx = reg.next_index("engine.decode_step") \
            if reg is not None else None
        attempt = 0
        while True:
            try:
                if reg is not None:
                    # retries re-probe the SAME invocation index with a
                    # bumped attempt (the loader.next convention): step=N
                    # rules stay one-shot transients, p-rules resample
                    reg.raise_if_armed("engine.decode_step", index=idx,
                                       attempt=attempt)
                with span(span_name, process=self.process,
                          lane="scheduler",
                          slots=int(feats["alive"].sum())):
                    out = call(feats)
                    # blocks on the result BEFORE adopting the returned
                    # pool: an async device fault surfaces here, and
                    # self._pool must still name the donated (deleted)
                    # inputs so _pool_alive() below escalates to the
                    # engine-fatal rebuild — adopting first would judge
                    # the FAILED call's outputs alive and re-dispatch
                    # feats whose buffers were consumed
                    logits = np.asarray(out["logits"])
                    self._pool = {k: v for k, v in out.items()
                                  if k.startswith("cache_")}
                    return logits
            except Exception as e:
                if not self._pool_alive():
                    raise          # donated pool consumed: engine-fatal
                attempt += 1
                if attempt == 1:
                    log.warning("shared %s failed (%s) — "
                                "re-dispatching once", span_name, e)
                    self._c_redispatches.inc()
                    continue
                victim = max(self._live.values(),
                             key=lambda s: s.admit_seq)
                log.warning("shared %s failed twice — "
                            "evicting newest-admitted request %s and "
                            "re-dispatching %d survivor(s): %s",
                            span_name, victim.req.request_id,
                            len(self._live) - 1, e)
                if self._flightrec is not None:
                    self._flightrec.incident(
                        "poison_eviction",
                        detail=f"request {victim.req.request_id}: "
                               f"{type(e).__name__}: {e}",
                        extra={"survivors": len(self._live) - 1,
                               "dispatch": span_name})
                self._fail_slot(victim, PoisonedRequestError(
                    f"request {victim.req.request_id} evicted after "
                    f"repeated shared-decode failure "
                    f"({type(e).__name__}: {e}); surviving requests "
                    "re-dispatched undisturbed"))
                if not self._live:
                    return None
                feats = rebuild()
                self._c_redispatches.inc()

    @scheduler_thread
    def _propose_drafts(self) -> None:
        """Ask each eligible live slot's drafter for up to
        ``spec_tokens - 1`` draft tokens (request-level ``spec_tokens``
        caps lower), stashing them on ``slot.draft``. Ineligible:
        sampled/opted-out slots (no drafter), teacher-forced slots
        (their next tokens are KNOWN — forcing is already free of
        sampling), slots one token from ``max_new`` (nothing to win),
        and slots with a pending prefix-cache insert (the insert must
        observe a prompt-pure tail block). NOT the verify-dispatch
        trigger: block securing may still DROP a slot's drafts under
        pressure, so :meth:`_shared_step` re-derives the trigger from
        the surviving ``slot.draft`` lists afterwards."""
        capacity = self.blocks_per_slot * self.block_size
        for s in self._live.values():
            s.draft = []
            if s.drafter is None or s.forced \
                    or s.pending_insert is not None:
                continue
            width = (self.spec_tokens if s.req.spec_tokens is None
                     else min(s.req.spec_tokens, self.spec_tokens))
            k = min(width - 1,
                    s.req.max_new - s.emitted - 1,
                    capacity - 1 - s.pos)
            if k < 1:
                continue
            s.draft = s.drafter.propose(k)

    @scheduler_thread
    def _shared_step(self) -> None:
        """ONE batched dispatch for every live slot: the single-token
        decode step, or — when speculation is on and any slot drafted —
        the K-token verify program (draftless slots ride at width 1)."""
        if self.paged:
            if self._verify_width:
                self._propose_drafts()
            # secure every live row's write span first: allocate-on-
            # write at block boundaries, copy-on-write on shared blocks.
            # A row that cannot get a block fails ALONE — its neighbors
            # still step; a SPEC row that cannot get its draft span
            # drops the drafts first (degrading to the normal step is
            # strictly better than dying for an optimization).
            for s in list(self._live.values()):
                try:
                    try:
                        self._ensure_write_block(s, 1 + len(s.draft))
                    except BlocksExhaustedError:
                        if not s.draft:
                            raise
                        span_end = s.pos + len(s.draft)
                        s.draft = []
                        self._release_trailing_blocks(s, span_end)
                        self._ensure_write_block(s, 1)
                except BlocksExhaustedError as e:
                    self._fail_slot(s, BlocksExhaustedError(
                        f"out of cache blocks mid-decode after "
                        f"{len(s.tokens)} tokens: {e}"))
                except Exception as e:
                    # e.g. an injected pool.alloc fault: quarantine the
                    # one row whose write target failed (the pool-
                    # consuming case — a failed COW copy — escalates)
                    if not self._pool_alive():
                        raise
                    self._fail_slot(s, PoisonedRequestError(
                        f"request {s.req.request_id}: cache write-"
                        f"block allocation failed "
                        f"({type(e).__name__}: {e})"))
            if not self._live:
                self._last_dispatch_t = 0.0
                return
        # decode-stall accounting: slots that survived the previous
        # shared dispatch experienced everything since its end —
        # monolithic prefills, prefill chunks, admissions — as stall;
        # chunked prefill exists to bound this histogram's tail
        if self._last_dispatch_t:
            self._h_decode_stall.observe(
                time.perf_counter() - self._last_dispatch_t)
        use_verify = any(s.draft for s in self._live.values())
        if use_verify:
            self._c_spec_proposed.inc(
                sum(len(s.draft) for s in self._live.values()))
            feats = self._build_verify_feats()
            t0 = time.perf_counter()
            logits = self._dispatch_decode(
                feats, call=self.sw.verify,
                rebuild=self._build_verify_feats,
                span_name="verify_step")
        else:
            feats = self._build_step_feats()
            t0 = time.perf_counter()
            logits = self._dispatch_decode(feats)
        if logits is None:
            self._last_dispatch_t = 0.0
            return
        self._retry.observe(time.perf_counter() - t0)
        with self.registry.atomic():
            if use_verify:
                self._c_verify_steps.inc()
            else:
                self._c_decode_steps.inc()
                self._c_decode_slot_steps.inc(len(self._live))
        advance = rows = 0
        for i, s in list(self._live.items()):
            rows += 1
            if s.forced:
                s.pos += 1
                advance += 1
                # teacher-forced prompt suffix: the next token is
                # already known — this step's logits are scaffolding
                s.last_tok = s.forced.pop(0)
                if not s.forced:
                    s.t_forced_done = time.perf_counter()
                continue
            if s.pending_insert is not None and \
                    self.prefix_cache is not None:
                # the whole prompt is now resident in this slot's
                # blocks: cache it. Inserting shares the tail block,
                # so this slot's NEXT write copy-on-writes it — the
                # cached bytes stay pure, same as the cold path.
                # (_propose_drafts never drafts under a pending
                # insert, so the shared tail holds prompt bytes only.)
                tokens = s.pending_insert
                nb = -(-int(tokens.size) // self.block_size)
                self.prefix_cache.insert(
                    tokens, [int(b) for b in self._tables[s.index, :nb]])
                s.pending_insert = None
            row_logits = logits[i]          # [V], or [K, V] on verify
            if s.draft:
                # exact greedy rejection: accept the longest draft
                # prefix matching the argmax chain, then ONE more token
                # — the correction at the first mismatch, or the bonus
                # from the last lane when every draft held. Emitted in
                # order through _emit, so EOS / stop_sequences / max_new
                # cut the stream at exactly the non-speculative
                # boundary.
                drafts, s.draft = s.draft, []
                emitted, acc = [], 0
                for j, d in enumerate(drafts):
                    a = int(np.argmax(row_logits[j]))
                    if a != d:
                        emitted.append(a)
                        break
                    emitted.append(d)
                    acc += 1
                else:
                    emitted.append(int(np.argmax(row_logits[
                        len(drafts)])))
                span_end = s.pos + len(drafts)
                s.pos += acc + 1            # the rejection rewind
                advance += acc + 1
                s.spec_accepted += acc
                self._c_spec_accepted.inc(acc)
                # _emit re-adds a still-live slot to _live and expects
                # the caller to have removed it first — so the slot is
                # popped before EVERY emission, not just the first
                # (leaving it mounted across a mid-run retirement
                # would double-retire it next step)
                retired = False
                n_emitted = 0
                for tok in emitted:
                    del self._live[i]
                    self._emit(s, tok)
                    n_emitted += 1
                    retired = s.index not in self._live
                    if retired:
                        break               # EOS / stop / max_new
                self._c_spec_emitted.inc(n_emitted)
                if not retired:
                    self._release_trailing_blocks(s, span_end)
                continue
            s.pos += 1
            advance += 1
            nxt = self._pick(s, row_logits[0] if use_verify
                             else row_logits)
            del self._live[i]           # _emit re-adds if still live
            self._emit(s, nxt)
        if rows:
            self._retry.observe_advance(advance / rows)
        live = list(self._live.values())
        self._steps_to_free_hint = (
            self._retry.dispatches_for(
                min(s.remaining_steps() for s in live)) if live
            else 1.0)
        # stamp this dispatch's end while anyone is still decoding —
        # the next dispatch's stall sample starts here (0 = nobody
        # carries across, no sample)
        self._last_dispatch_t = time.perf_counter() if live else 0.0

    # ---- observability ----------------------------------------------
    @snapshot_view
    def metrics_snapshot(self) -> dict:
        """ONE atomic registry snapshot, gauges freshened first — the
        backing read for both ``/stats`` and ``/metrics`` (so their
        counter values can never disagree about the same instant, and
        a concurrent scheduler mutation can never be observed torn:
        grouped updates hold the registry lock the snapshot takes)."""
        now = time.perf_counter()
        with self._cond:
            self._g_queue_depth.set(len(self._queue))
            self._g_live_slots.set(len(self._live))
            self._g_prefilling_slots.set(len(self._prefilling))
            self._g_queue_age.set(round(self._queue_age_s(now), 4))
        self._g_pressure_level.set(self._pressure_level)
        with self.registry.atomic():
            proposed = self._c_spec_proposed.value
            self._g_accept_rate.set(
                round(self._c_spec_accepted.value / proposed, 4)
                if proposed else 0.0)
        if self.paged:
            with self.registry.atomic():
                free = self.blocks.free_count
                self._g_blocks_free.set(free)
                self._g_bytes_resident.set(
                    (self.blocks.usable - free) * self._block_bytes)
                self._g_bytes_resident_peak.set(
                    self.blocks.peak_in_use * self._block_bytes)
                if self.prefix_cache is not None:
                    self._g_prefix_entries.set(len(self.prefix_cache))
        return self.registry.snapshot()

    @snapshot_view
    def stats(self, snapshot: dict | None = None) -> dict:
        """The legacy ``/stats`` dict — now a pure VIEW of the registry
        snapshot (pass one in to share it with a ``/metrics`` render of
        the same instant)."""
        snap = self.metrics_snapshot() if snapshot is None else snapshot
        with self._cond:
            lat = list(self._latencies)

        def c(name):
            return snap[name]["value"]

        decode_steps = c("serving_decode_steps_total")
        shared = (c("serving_decode_slot_steps_total") / decode_steps
                  if decode_steps else 0.0)
        out = {
            "slots": self.slots,
            "kv_cache_dtype": self.kv_cache_dtype,
            "live_slots": c("serving_live_slots"),
            "queue_depth": c("serving_queue_depth"),
            "admissions": c("serving_admissions_total"),
            "prefills": c("serving_prefills_total"),
            "decode_steps": decode_steps,
            "decode_slot_steps": c("serving_decode_slot_steps_total"),
            "steps_shared": round(shared, 3),
            "requests_done": c("serving_requests_done_total"),
            "requests_failed": c("serving_requests_failed_total"),
            "cancelled": c("serving_cancelled_total"),
            "deadline_expired": c("serving_deadline_expired_total"),
            "redispatches": c("serving_redispatches_total"),
            "drain_ms": c("serving_drain_ms"),
            "tokens_out": c("serving_tokens_out_total"),
            # speculative decoding (zeros while spec_tokens=0): the
            # accept_rate here and the /metrics gauge read the same
            # snapshot, so they can never disagree
            "spec_tokens": self.spec_tokens,
            "verify_steps": c("serving_verify_steps_total"),
            "spec_proposed": c("serving_spec_proposed_total"),
            "spec_accepted": c("serving_spec_accepted_total"),
            "spec_emitted": c("serving_spec_emitted_total"),
            "accept_rate": c("serving_spec_accept_rate"),
            # SLO-aware overload resilience (round 18): the shedding /
            # pressure / chunked-prefill story at a glance
            "pressure": PRESSURE_STATES[self._pressure_level],
            "pressure_level": c("serving_pressure_level"),
            "pressure_transitions": c(
                "serving_pressure_transitions_total"),
            "queue_age_s": c("serving_queue_age_seconds"),
            "shed": c("serving_shed_total"),
            "shed_interactive": c("serving_shed_interactive_total"),
            "shed_batch": c("serving_shed_batch_total"),
            "shed_best_effort": c("serving_shed_best_effort_total"),
            "shed_infeasible": c("serving_shed_infeasible_total"),
            "prefill_chunk_tokens": self.prefill_chunk_tokens,
            "prefill_chunks": c("serving_prefill_chunks_total"),
            "prefilling_slots": c("serving_prefilling_slots"),
            # SLO attainment observables (round 19): the aggregate
            # served/good pair and goodput tokens at a glance — the
            # per-class pairs and windowed rates live on /metrics and
            # GET /stats/history
            "slo_served": c("serving_slo_served_total"),
            "slo_good": c("serving_slo_good_total"),
            "goodput_tokens": c("serving_goodput_tokens_total"),
            "latency_p50_ms": round(percentile(lat, 50) * 1e3, 2),
            "latency_p95_ms": round(percentile(lat, 95) * 1e3, 2),
            "latency_p99_ms": round(percentile(lat, 99) * 1e3, 2),
        }
        if self.paged:
            # block-level observability: residency is ACTUAL tokens,
            # not slots × worst-case depth — the paged pool's whole
            # point, so it must be visible at /stats
            out.update({
                "paged": True,
                "block_size": self.block_size,
                "blocks_total": self.blocks.usable,
                "blocks_free": c("serving_blocks_free"),
                "bytes_resident": c("serving_bytes_resident"),
                "bytes_resident_peak": c("serving_bytes_resident_peak"),
                "prefix_cache_hits": (
                    c("serving_prefix_cache_hits_total")
                    if self.prefix_cache is not None else 0),
                "prefix_cache_misses": (
                    c("serving_prefix_cache_misses_total")
                    if self.prefix_cache is not None else 0),
                "prefix_cache_entries": (
                    c("serving_prefix_cache_entries")
                    if self.prefix_cache is not None else 0),
                "prefill_tokens_saved": c(
                    "serving_prefill_tokens_saved_total"),
                "cow_copies": c("serving_cow_copies_total"),
            })
        return out


class MicroBatcher:
    """Dynamic micro-batching for ``:predict`` requests.

    Handler threads :meth:`submit` feature rows; a single batcher
    thread gathers up to ``batch_max_size`` rows or
    ``batch_max_wait_ms`` (whichever first), pads the gathered count
    up to a power-of-two bucket (repeating the first row — the
    framework's established pad convention, which also keeps a padded
    BERT row live: a copy of a real row is never fully masked), runs
    the servable ONCE,
    and scatters the result rows back to the per-request futures.
    Bucketing bounds the executable count to log2(batch_max_size)+1
    shapes. Every forward export is batch-polymorphic, so any bucket is
    a legal shape.
    """

    def __init__(self, servable: ServableModel, *,
                 batch_max_size: int = 8, batch_max_wait_ms: float = 5.0,
                 max_queue: int = 256, registry: Registry | None = None,
                 process: str = "serving"):
        self.process = str(process)
        if batch_max_size < 1:
            raise ValueError(f"batch_max_size must be >= 1, got "
                             f"{batch_max_size}")
        if batch_max_wait_ms < 0:
            raise ValueError(f"batch_max_wait_ms must be >= 0, got "
                             f"{batch_max_wait_ms}")
        self.servable = servable
        self.batch_max_size = batch_max_size
        self.batch_max_wait_s = batch_max_wait_ms / 1e3
        self.max_queue = max_queue
        self._queue: deque[tuple[dict, int, Future, float]] = deque()
        self._cond = threading.Condition()
        self._running = False
        self._thread: threading.Thread | None = None
        # stats: registry-owned (shared with the engine's /metrics
        # page when the server passes its registry in)
        self.registry = registry if registry is not None else Registry(
            namespace="serving")
        self._c_batches = self.registry.counter(
            "predict_batches_total", "micro-batch dispatches")
        self._c_rows = self.registry.counter(
            "predict_rows_total", "client rows served")
        self._c_padded = self.registry.counter(
            "predict_padded_rows_total",
            "bucket-padding rows dispatched beyond client rows")
        self._g_queue_depth = self.registry.gauge(
            "predict_queue_depth", "requests waiting for a micro-batch")
        self._h_latency = self.registry.histogram(
            "predict_request_latency_seconds",
            "submit-to-scatter request latency")
        self._latencies: deque[float] = deque(maxlen=2048)
        # queue-full Retry-After from MEASURED micro-batch wall time
        # (the same estimator semantics the :generate path uses) — a
        # 429 should tell the client when capacity actually frees, not
        # a hard-coded guess
        self._retry = RetryAfterEstimator()

    @property
    def batches(self) -> int:
        return self._c_batches.value

    @property
    def rows(self) -> int:
        return self._c_rows.value

    @property
    def padded_rows(self) -> int:
        return self._c_padded.value

    def start(self) -> "MicroBatcher":
        with self._cond:
            if self._running:
                return self
            self._running = True
        self._thread = threading.Thread(target=self._loop,
                                        name="predict-batcher",
                                        daemon=True)
        self._thread.start()
        return self

    def close(self, timeout: float = 10.0) -> None:
        with self._cond:
            self._running = False
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                # same contract as GenerationEngine.close: a batcher
                # thread that never parks is loud, not silently leaked
                raise EngineStalledError(
                    f"predict-batcher thread failed to park within "
                    f"{timeout:.1f}s of close() — wedged mid-dispatch "
                    "(queued requests were NOT failed)")
            self._thread = None
        err = RuntimeError("predict batcher stopped")
        with self._cond:
            for _, _, fut, _ in self._queue:
                fut.set_exception(err)
            self._queue.clear()

    def submit(self, feats: dict[str, np.ndarray], n: int) -> Future:
        """Queue ``n`` rows of already-validated feature arrays."""
        fut = Future()
        with self._cond:
            if not self._running:
                raise RuntimeError("batcher is not running")
            if len(self._queue) >= self.max_queue:
                # steps_to_free=1: the next batch dispatch frees queue
                # room; the queue ahead scales it into admission waves
                raise QueueFullError(
                    f"predict queue full ({self.max_queue} requests "
                    "waiting)",
                    retry_after=round(self._retry.estimate(
                        1.0, queue_ahead=len(self._queue),
                        slots=self.batch_max_size), 2))
            self._queue.append((feats, n, fut, time.perf_counter()))
            self._cond.notify_all()
        return fut

    def _gather(self) -> list[tuple[dict, int, Future, float]]:
        """Admission: the first queued request opens a
        ``batch_max_wait_ms`` window; whatever arrives inside it (up
        to ``batch_max_size`` rows) shares the dispatch."""
        with self._cond:
            while self._running and not self._queue:
                self._cond.wait(timeout=0.5)
            if not self._running:
                return []
            deadline = time.monotonic() + self.batch_max_wait_s
            taken = [self._queue.popleft()]
            rows = taken[0][1]
            while rows < self.batch_max_size:
                if self._queue:
                    nxt_rows = self._queue[0][1]
                    if rows + nxt_rows > self.batch_max_size:
                        break
                    item = self._queue.popleft()
                    taken.append(item)
                    rows += item[1]
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
            return taken

    def _bucket(self, n: int) -> int:
        """Always a power of two — even an oversized single request
        rounds UP, so the shape count stays log-bounded instead of
        growing by one per odd row count."""
        b = 1
        while b < n:
            b *= 2
        return b

    def _loop(self) -> None:
        while True:
            taken = self._gather()
            if not taken:
                with self._cond:
                    if not self._running:
                        return
                continue
            try:
                self._run(taken)
            except Exception as e:
                for _, _, fut, _ in taken:
                    fut.set_exception(e)

    def _run(self, taken) -> None:
        n_total = sum(n for _, n, _, _ in taken)
        bucket = self._bucket(n_total)
        keys = taken[0][0].keys()
        cols = {k: np.concatenate([feats[k] for feats, _, _, _ in taken])
                for k in keys}
        if n_total < bucket:
            cols = {k: np.concatenate(
                [v, np.repeat(v[:1], bucket - n_total, axis=0)])
                for k, v in cols.items()}
        t0 = time.perf_counter()
        with span("predict_batch", process=self.process,
                  lane="batcher", rows=n_total,
                  bucket=bucket):
            preds = np.asarray(self.servable(cols))
        self._retry.observe(time.perf_counter() - t0)
        with self.registry.atomic():
            self._c_batches.inc()
            self._c_rows.inc(n_total)
            self._c_padded.inc(bucket - n_total)
        now = time.perf_counter()
        off = 0
        for feats, n, fut, t0 in taken:
            self._h_latency.observe(now - t0)
            self._latencies.append(now - t0)
            fut.set_result(preds[off:off + n])
            off += n

    def metrics_snapshot(self) -> dict:
        with self._cond:
            self._g_queue_depth.set(len(self._queue))
        return self.registry.snapshot()

    def stats(self, snapshot: dict | None = None) -> dict:
        snap = self.metrics_snapshot() if snapshot is None else snapshot
        with self._cond:
            lat = list(self._latencies)
        return {
            "queue_depth": snap["predict_queue_depth"]["value"],
            "batches": snap["predict_batches_total"]["value"],
            "rows": snap["predict_rows_total"]["value"],
            "padded_rows": snap["predict_padded_rows_total"]["value"],
            "batch_max_size": self.batch_max_size,
            "latency_p50_ms": round(percentile(lat, 50) * 1e3, 2),
            "latency_p95_ms": round(percentile(lat, 95) * 1e3, 2),
            "latency_p99_ms": round(percentile(lat, 99) * 1e3, 2),
        }
