"""Operator tools of the port (``servetop``)."""
