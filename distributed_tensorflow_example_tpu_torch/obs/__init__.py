"""Observability of the port (copies of the reference's ``obs`` modules,
standard library only):

- :mod:`.registry` — counters, gauges and fixed-bucket histograms with
  one lock and atomic, mergeable snapshots;
- :mod:`.prom` — a snapshot as Prometheus text (``GET /metrics``);
- :mod:`.trace` — spans, the ring recorder, trace contexts;
- :mod:`.timeseries` — the snapshot ring and its window queries
  (``GET /stats/history``);
- :mod:`.slo` — objectives, SLIs and multi-window burn rates;
- :mod:`.flightrec` — rate-limited incident bundles;
- :mod:`.stitch` — clock offsets and the stitched fleet timeline
  (``GET /trace/fleet``).
"""
