"""Structured logging.

Counterpart of :mod:`mapreduce_tpu.runtime.logging` under the port's own
logger name: a standard ``logging`` logger on stderr, and
:func:`log_event` for a message with structured fields (kept on the record
as ``fields`` and printed as ``key=value``).  Stdout stays the CLI's
result.
"""

from __future__ import annotations

import logging
import sys

LOGGER_NAME = "mapreduce_tpu_torch"


class _TextFormatter(logging.Formatter):
    """``time level name: message key=value ...``."""

    def format(self, record: logging.LogRecord) -> str:
        line = super().format(record)
        extra = getattr(record, "fields", None)
        if extra:
            line += " " + " ".join(f"{k}={v}" for k, v in extra.items())
        return line


class _StderrHandler(logging.StreamHandler):
    """A stream handler on whatever ``sys.stderr`` is at each record, so a
    redirected or captured stderr gets the records of later runs."""

    @property
    def stream(self):
        return sys.stderr

    @stream.setter
    def stream(self, _value) -> None:
        pass


def get_logger() -> logging.Logger:
    """The port's logger, with its stderr handler (INFO) attached once."""
    logger = logging.getLogger(LOGGER_NAME)
    if not any(isinstance(h, _StderrHandler) for h in logger.handlers):
        h = _StderrHandler()
        h.setFormatter(_TextFormatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def log_event(logger: logging.Logger, msg: str, **fields) -> None:
    logger.info(msg, extra={"fields": fields})
