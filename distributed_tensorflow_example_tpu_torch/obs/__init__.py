"""Observability of the port: the metrics registry and request-scoped
trace spans (adapted copies of the reference's ``obs`` modules)."""
