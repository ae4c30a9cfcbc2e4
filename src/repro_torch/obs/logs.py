"""One logging config for the service and fleet CLIs.

Every record carries the correlation ids from the current trace baggage
(campaign/worker/lease), so grep-by-campaign works across the service
log and any number of fleet worker logs without the call sites passing
ids around.  Call sites just use ``obs.get_logger(__name__)``.
"""

from __future__ import annotations

import logging
import sys
from typing import Optional

from . import trace

__all__ = ["setup_logging", "get_logger", "parse_level"]

_FORMAT = (
    "%(asctime)s %(levelname)-7s %(name)s "
    "[campaign=%(campaign)s worker=%(obs_worker)s] %(message)s"
)


class _ContextFilter(logging.Filter):
    """Stamp trace-baggage correlation ids onto every record."""

    def filter(self, record: logging.LogRecord) -> bool:
        bag = trace.current_baggage()
        record.campaign = bag.get("campaign", "-")
        # "worker" collides with nothing, but LogRecord reserves no
        # namespace — prefix defensively
        record.obs_worker = bag.get("worker", "-")
        return True


def parse_level(level: str) -> int:
    v = getattr(logging, str(level).upper(), None)
    if not isinstance(v, int):
        raise ValueError(f"unknown log level {level!r}")
    return v


def setup_logging(level: str = "info", *, stream=None,
                  root: str = "repro_torch") -> logging.Logger:
    """Configure the ``repro_torch`` logger tree once; idempotent
    (re-calls just update the level).  Returns its root logger."""
    logger = logging.getLogger(root)
    logger.setLevel(parse_level(level))
    if not any(getattr(h, "_repro_obs", False) for h in logger.handlers):
        handler = logging.StreamHandler(stream or sys.stderr)
        handler.setFormatter(
            logging.Formatter(_FORMAT, datefmt="%H:%M:%S")
        )
        handler.addFilter(_ContextFilter())
        handler._repro_obs = True
        logger.addHandler(handler)
        logger.propagate = False
    return logger


def get_logger(name: Optional[str] = None) -> logging.Logger:
    """A logger under the ``repro_torch`` tree.  Dotted module paths like
    ``repro_torch.core.features.synth`` pass through; bare names nest
    under it."""
    if not name:
        return logging.getLogger("repro_torch")
    if not name.startswith("repro_torch"):
        name = f"repro_torch.{name}"
    return logging.getLogger(name)
