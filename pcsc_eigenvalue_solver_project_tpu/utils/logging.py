"""Structured logging for solver runs.

The reference's observability contract is the ``iterations``/``converged``
result fields plus demo ``std::cout`` (SURVEY.md §5). This module adds the
framework-level layer on top: a standard-library logger namespaced
``eigsol`` and a JSON-line event emitter used by bench/parity tooling.
"""

from __future__ import annotations

import json
import logging
import sys
import time

LOGGER_NAME = "eigsol"


def get_logger(name: str | None = None) -> logging.Logger:
    logger = logging.getLogger(f"{LOGGER_NAME}.{name}" if name else LOGGER_NAME)
    if not logging.getLogger(LOGGER_NAME).handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logging.getLogger(LOGGER_NAME).addHandler(h)
        logging.getLogger(LOGGER_NAME).setLevel(logging.INFO)
    return logger


def emit_event(kind: str, stream=None, **fields) -> None:
    """One JSON line per event (bench results, parity reports, timings)."""
    rec = {"event": kind, "ts": round(time.time(), 3), **fields}
    print(json.dumps(rec), file=stream or sys.stderr)


def log_result(name: str, res) -> None:
    """Log a solver result's observability fields."""
    get_logger("solver").info(
        "%s: eigenvalue=%s iterations=%d converged=%s",
        name, complex(res.eigenvalue) if hasattr(res, "eigenvalue") else "-",
        int(res.iterations), bool(res.converged))
