"""SLO attainment and error-budget burn rates over a snapshot history (a
copy of ``distributed_tensorflow_example_tpu/obs/slo.py``, standard
library only). Every function here is pure over an injected history: no
threads, no sleeps, no registry references.

**Objectives** (``--slo_spec``, grammar ``class:kind=target[@goal]``
joined with ``;``):

=================  =====================================================
kind                the SLI it compiles to (good / total over a window)
=================  =====================================================
``hit_rate``        deadline hit rate: ``serving_slo_good_<class>_total``
                    over ``serving_slo_served_<class>_total`` (class
                    ``all`` reads the aggregate pair). ``=X`` is the goal.
``p95_ms``          latency: observations of
                    ``serving_latency_<class>_seconds`` at or under the
                    target (interpolated within the bucket) over the
                    window count; class ``all`` reads
                    ``serving_request_latency_seconds``. ``@goal``
                    defaults to 0.95.
``availability``    requests not failed by the server: ``served -
                    serving_requests_failed_total`` over served (class
                    ``all`` only). ``=X`` is the goal.
=================  =====================================================

**Burn rate**: with error rate ``e = 1 - good/total`` over a window and
budget ``1 - goal``, ``burn = e / (1 - goal)``. :func:`evaluate` computes
burn over a FAST and a SLOW window and flags ``breach`` only when both
exceed the threshold with observations in both (the multi-window rule).

The server hangs :func:`evaluate` off the sampler and turns a breach into
a rate-limited ``slo_burn`` flight-recorder bundle; ``/healthz`` carries
:func:`summarize` as an advisory field that never changes its status.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from . import timeseries as ts

#: objective kinds (the grammar's vocabulary)
KINDS = ("hit_rate", "p95_ms", "availability")

#: priority classes + the aggregate pseudo-class
CLASSES = ("interactive", "batch", "best_effort", "all")

#: default evaluation windows/threshold (server knobs override)
FAST_WINDOW_S = 60.0
SLOW_WINDOW_S = 600.0
BURN_THRESHOLD = 2.0


@dataclasses.dataclass(frozen=True)
class Objective:
    """One declarative objective: ``goal`` of class ``cls`` traffic
    must be good, where good is defined by ``kind`` (and ``target``
    for the latency kind, in milliseconds)."""
    cls: str
    kind: str
    target: float       # p95_ms: the latency bound (ms); else == goal
    goal: float         # required good fraction, in (0, 1)

    def __post_init__(self):
        if self.cls not in CLASSES:
            raise ValueError(f"objective class must be one of "
                             f"{CLASSES}, got {self.cls!r}")
        if self.kind not in KINDS:
            raise ValueError(f"objective kind must be one of {KINDS}, "
                             f"got {self.kind!r}")
        if self.kind == "availability" and self.cls != "all":
            raise ValueError(
                "availability objectives are class 'all' only "
                "(serving_requests_failed_total is not classed)")
        if not 0.0 < self.goal < 1.0:
            raise ValueError(f"goal must be in (0, 1), got {self.goal}")
        if self.kind == "p95_ms" and self.target <= 0:
            raise ValueError(f"p95_ms target must be > 0 ms, got "
                             f"{self.target}")

    def key(self) -> str:
        return f"{self.cls}:{self.kind}"

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def parse_slo_spec(spec: str) -> list[Objective]:
    """``class:kind=target[@goal];...`` -> objectives, loudly.

    >>> parse_slo_spec("interactive:p95_ms=250@0.95;all:availability=0.999")
    """
    out: list[Objective] = []
    seen: set[str] = set()
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        head, sep, val = part.partition("=")
        if not sep:
            raise ValueError(
                f"slo_spec entry {part!r}: expected "
                "class:kind=target[@goal]")
        cls, sep, kind = head.strip().partition(":")
        if not sep:
            raise ValueError(
                f"slo_spec entry {part!r}: expected class:kind "
                f"(classes {CLASSES}, kinds {KINDS})")
        val, _, goal_s = val.partition("@")
        try:
            target = float(val)
            goal = float(goal_s) if goal_s else None
        except ValueError as e:
            raise ValueError(f"slo_spec entry {part!r}: {e}") from None
        kind = kind.strip()
        if kind == "p95_ms":
            goal = 0.95 if goal is None else goal
        else:
            if goal is not None:
                raise ValueError(
                    f"slo_spec entry {part!r}: {kind} takes no @goal "
                    "(the =value IS the goal)")
            goal = target
        obj = Objective(cls=cls.strip(), kind=kind, target=target,
                        goal=goal)
        if obj.key() in seen:
            raise ValueError(f"slo_spec repeats objective {obj.key()!r}")
        seen.add(obj.key())
        out.append(obj)
    if not out:
        raise ValueError(f"slo_spec {spec!r} declares no objectives")
    return out


def default_objectives() -> list[Objective]:
    """The objectives an armed sampler evaluates when ``--slo_spec``
    is unset: interactive latency + hit rate, fleet availability."""
    return [
        Objective("interactive", "p95_ms", 1000.0, 0.95),
        Objective("interactive", "hit_rate", 0.99, 0.99),
        Objective("all", "availability", 0.999, 0.999),
    ]


# ---------------------------------------------------------------------------
# SLI: (good, total) over a window
# ---------------------------------------------------------------------------

def _counter_pair(cls: str) -> tuple[str, str]:
    if cls == "all":
        return "serving_slo_good_total", "serving_slo_served_total"
    return (f"serving_slo_good_{cls}_total",
            f"serving_slo_served_{cls}_total")


def _latency_hist(cls: str) -> str:
    if cls == "all":
        return "serving_request_latency_seconds"
    return f"serving_latency_{cls}_seconds"


def sli(win: Sequence[ts.Sample], obj: Objective
        ) -> tuple[float, float]:
    """The objective's ``(good, total)`` event counts over the window
    — every kind reduces to this ratio shape, which is what makes one
    burn-rate formula serve all three."""
    if obj.kind == "hit_rate":
        g, s = _counter_pair(obj.cls)
        return float(ts.delta(win, g)), float(ts.delta(win, s))
    if obj.kind == "availability":
        _, s = _counter_pair(obj.cls)
        served = float(ts.delta(win, s))
        failed = float(ts.delta(win, "serving_requests_failed_total"))
        return max(0.0, served - failed), served
    # p95_ms: observations at/under the bound over window count
    name = _latency_hist(obj.cls)
    d = ts.delta(win, name)
    total = float(d["count"]) if isinstance(d, dict) else 0.0
    if total <= 0:
        return 0.0, 0.0
    return ts.good_below(win, name, obj.target / 1e3), total


def burn_rate(good: float, total: float, goal: float) -> float:
    """Error-budget burn: ``(1 - good/total) / (1 - goal)``; 0.0 with
    no observations (an idle window burns nothing)."""
    if total <= 0:
        return 0.0
    err = 1.0 - good / total
    return err / (1.0 - goal)


def evaluate(history: Sequence[ts.Sample],
             objectives: Sequence[Objective], *,
             now: float | None = None,
             fast_s: float = FAST_WINDOW_S,
             slow_s: float = SLOW_WINDOW_S,
             threshold: float = BURN_THRESHOLD) -> list[dict[str, Any]]:
    """Evaluate every objective over the history: attainment (slow
    window — the canonical reporting window), fast/slow burn rates,
    and the multi-window ``breach`` flag. Pure: ``now`` defaults to
    the newest sample's stamp, so a dumped history evaluates
    identically offline."""
    fast = ts.window(history, fast_s, now)
    slow = ts.window(history, slow_s, now)
    out: list[dict[str, Any]] = []
    for obj in objectives:
        g_f, t_f = sli(fast, obj)
        g_s, t_s = sli(slow, obj)
        b_f = burn_rate(g_f, t_f, obj.goal)
        b_s = burn_rate(g_s, t_s, obj.goal)
        rec: dict[str, Any] = {
            "class": obj.cls, "kind": obj.kind,
            "target": obj.target, "goal": obj.goal,
            "good": round(g_s, 3), "total": round(t_s, 3),
            "attainment": round(g_s / t_s, 6) if t_s > 0 else None,
            "burn_fast": round(b_f, 4), "burn_slow": round(b_s, 4),
            "breach": (t_f > 0 and t_s > 0
                       and b_f >= threshold and b_s >= threshold),
        }
        if obj.kind == "p95_ms":
            rec["measured_p95_ms"] = round(
                ts.quantile(slow, _latency_hist(obj.cls), 0.95) * 1e3,
                3)
        out.append(rec)
    return out


def summarize(results: Sequence[dict[str, Any]]) -> dict[str, Any]:
    """The compact advisory block ``/healthz`` carries: objective
    count, the breaching ``class:kind`` keys, and the worst burn with
    its owner — enough for an operator probe, with the full story on
    ``GET /stats/history``."""
    worst = max(results, key=lambda r: r["burn_fast"], default=None)
    return {
        "objectives": len(results),
        "breaching": [f"{r['class']}:{r['kind']}" for r in results
                      if r["breach"]],
        "worst_burn": (None if worst is None else {
            "objective": f"{worst['class']}:{worst['kind']}",
            "burn_fast": worst["burn_fast"],
            "burn_slow": worst["burn_slow"],
            "attainment": worst["attainment"]}),
    }
