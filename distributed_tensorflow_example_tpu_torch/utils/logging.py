"""Logging shim over stdlib logging (port of the reference's
``utils/logging.py``)."""

from __future__ import annotations

import logging
import sys

_FORMAT = "%(asctime)s %(levelname).1s %(name)s] %(message)s"
_configured = False


def get_logger(name: str = "dtx") -> logging.Logger:
    global _configured
    if not _configured:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FORMAT))
        root = logging.getLogger("dtx")
        root.addHandler(h)
        root.setLevel(logging.INFO)
        root.propagate = False
        _configured = True
    return logging.getLogger(name if name.startswith("dtx") else f"dtx.{name}")
