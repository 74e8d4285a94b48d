"""Prometheus text-format exposition of a registry snapshot (a copy of
``distributed_tensorflow_example_tpu/obs/prom.py``, standard library
only).

``GET /metrics`` (``serving_http.py``) renders the SAME
:meth:`~.registry.Registry.snapshot` that backs ``/stats``, so the two
views cannot drift: neither holds its own counters. Output is the
classic text format (version 0.0.4): ``# HELP`` / ``# TYPE`` preamble per
metric, histogram ``_bucket{le=...}`` series in ascending ``le`` order
ending at ``+Inf``, then ``_sum`` and ``_count``. :func:`parse_snapshot`
is its exact inverse.
"""

from __future__ import annotations

from typing import Any

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _fmt(v: float | int) -> str:
    """Prometheus number formatting: integers bare, floats via repr
    (full precision — the /stats consistency contract is exact)."""
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f)


def _fmt_le(b: float) -> str:
    """Bucket bounds print without a trailing ``.0`` for whole numbers
    (``le="1"`` not ``le="1.0"``) — the convention Prometheus's own
    client libraries follow."""
    return str(int(b)) if float(b) == int(b) else repr(float(b))


def render(snapshot: dict[str, dict[str, Any]]) -> str:
    """Snapshot -> exposition text. Metric order is sorted by name so
    the output is deterministic (diffable in tests and scrapes)."""
    lines: list[str] = []
    for name in sorted(snapshot):
        rec = snapshot[name]
        kind = rec["type"]
        if rec.get("help"):
            # escape per the exposition format: backslash then newline
            h = rec["help"].replace("\\", r"\\").replace("\n", r"\n")
            lines.append(f"# HELP {name} {h}")
        lines.append(f"# TYPE {name} {kind}")
        if kind in ("counter", "gauge"):
            lines.append(f"{name} {_fmt(rec['value'])}")
            continue
        acc = 0
        for bound, count in rec["buckets"]:
            acc += count
            lines.append(f'{name}_bucket{{le="{_fmt_le(bound)}"}} {acc}')
        acc += rec["inf"]
        lines.append(f'{name}_bucket{{le="+Inf"}} {acc}')
        lines.append(f"{name}_sum {_fmt(rec['sum'])}")
        lines.append(f"{name}_count {rec['count']}")
    return "\n".join(lines) + "\n"


def parse(text: str) -> dict[str, float]:
    """Minimal inverse for tests and the bench row: ``{sample_name ->
    value}`` including ``_bucket{le=...}`` series keyed with their
    label (``name_bucket{le="0.5"}``). Not a general parser — it reads
    exactly what :func:`render` writes."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        key, _, val = line.rpartition(" ")
        out[key] = float(val)
    return out


def quantile_from_parsed(parsed: dict[str, float], name: str,
                         q: float) -> float:
    """Histogram quantile (Prometheus ``histogram_quantile`` rule:
    linear interpolation within the first bucket whose cumulative count
    reaches the rank) from a :func:`parse`-shaped sample dict —
    ``{name}_bucket{{le=...}}`` series + ``{name}_count``. Returns the
    upper bound of the +Inf-rank case as the largest finite bound (the
    conventional clamp), and 0.0 for an empty histogram. Percentiles of a scraped
    page come from the registry through this, not from client-side
    stopwatches."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q must be in [0, 1], got {q}")
    total = parsed.get(f"{name}_count", 0)
    if not total:
        return 0.0
    prefix = f'{name}_bucket{{le="'
    buckets: list[tuple[float, float]] = []
    for key, val in parsed.items():
        if not key.startswith(prefix):
            continue
        le = key[len(prefix):-2]          # strip trailing '"}'
        if le != "+Inf":
            buckets.append((float(le), val))
    buckets.sort()
    rank = q * total
    prev_bound, prev_cum = 0.0, 0.0
    for bound, cum in buckets:
        if cum >= rank:
            if cum == prev_cum:
                return bound
            return prev_bound + (bound - prev_bound) * (
                (rank - prev_cum) / (cum - prev_cum))
        prev_bound, prev_cum = bound, cum
    return buckets[-1][0] if buckets else 0.0


def _num(val: str) -> int | float:
    """Exposition number -> int when it round-trips exactly (counters
    and gauges rendered from int values must merge back as ints so
    /stats equality checks stay exact)."""
    f = float(val)
    return int(f) if f == int(f) else f


def _unescape_help(h: str) -> str:
    """Exact inverse of :func:`render`'s help escaping (``\\`` then
    ``\\n``) — what makes ``parse_snapshot(render(s)) == s`` hold even
    for multi-line help text (the round-trip completeness contract)."""
    out: list[str] = []
    i = 0
    while i < len(h):
        c = h[i]
        if c == "\\" and i + 1 < len(h):
            nxt = h[i + 1]
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
            if nxt == "\\":
                out.append("\\")
                i += 2
                continue
        out.append(c)
        i += 1
    return "".join(out)


def parse_snapshot(text: str) -> dict[str, dict]:
    """Exposition text -> a :meth:`~.registry.Registry.snapshot`-shaped
    dict, the exact inverse of :func:`render` — so a FLEET front-end
    can scrape each replica's ``/metrics`` page and
    combine them through :func:`~.registry.merge_snapshots` without a
    side channel to the replicas' in-process registries. Histogram
    ``_bucket`` series are de-cumulated back to per-bucket counts (the
    snapshot layout merge_snapshots sums); ``# TYPE`` lines drive the
    record shape; ``# HELP`` text is unescaped back to the registered
    string, so ``parse_snapshot(render(s)) == s`` exactly."""
    out: dict[str, dict] = {}
    helps: dict[str, str] = {}
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# HELP "):
            name, _, h = line[len("# HELP "):].partition(" ")
            helps[name] = _unescape_help(h)
            continue
        if line.startswith("# TYPE "):
            name, _, kind = line[len("# TYPE "):].partition(" ")
            if kind == "histogram":
                out[name] = {"type": "histogram", "buckets": [],
                             "inf": 0, "sum": 0.0, "count": 0,
                             "help": helps.get(name, "")}
            else:
                out[name] = {"type": kind, "value": 0,
                             "help": helps.get(name, "")}
            continue
        if line.startswith("#"):
            continue
        key, _, val = line.rpartition(" ")
        if key in out and out[key]["type"] in ("counter", "gauge"):
            out[key]["value"] = _num(val)
            continue
        # histogram series: <name>_bucket{le="..."} / _sum / _count
        if key.endswith("_sum") and key[:-4] in out:
            out[key[:-4]]["sum"] = float(val)
        elif key.endswith("_count") and key[:-6] in out:
            out[key[:-6]]["count"] = int(float(val))
        elif "_bucket{le=" in key:
            name = key.split("_bucket{le=", 1)[0]
            rec = out.get(name)
            if rec is None:
                continue
            le = key.split('le="', 1)[1].rstrip('"}')
            acc = int(float(val))
            prior = (sum(c for _, c in rec["buckets"]) + rec["inf"])
            if le == "+Inf":
                rec["inf"] = acc - prior
            else:
                rec["buckets"].append((float(le), acc - prior))
    return out
