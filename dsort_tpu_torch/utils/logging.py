"""Leveled structured logging: standard ``logging`` with a compact formatter.

Counterpart of ``dsort_tpu/utils/logging.py``; loggers live under the
``dsort_tpu_torch`` namespace, the level comes from ``DSORT_LOG_LEVEL``.
"""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s.%(msecs)03d %(levelname).1s %(name)s: %(message)s"
_DATEFMT = "%H:%M:%S"
_ROOT = "dsort_tpu_torch"


def get_logger(name: str) -> logging.Logger:
    root = logging.getLogger(_ROOT)
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, _DATEFMT))
        root.addHandler(handler)
        root.setLevel(os.environ.get("DSORT_LOG_LEVEL", "INFO").upper())
        root.propagate = False
    return logging.getLogger(f"{_ROOT}.{name}")
