"""Structured JSON logging (SURVEY.md §6 metrics/logging row; copied from
``kubegpu_tpu/obs/logging.py``).

The reference logged through glog verbosity levels only; KubeTPU emits
machine-parseable JSON lines — one object per event, stable keys
(``ts``, ``level``, ``component``, ``event`` + event fields) — so a log
pipeline (or grep + jq) can follow a pod through schedule → inject → run
without regex archaeology.

Built on the stdlib ``logging`` tree under the ``"kubetpu"`` root, so
embedders keep full control: attach handlers/levels per component, or
call :func:`configure` for the batteries-included JSON-lines-to-stderr
setup.  Loggers are cheap and process-global; components grab one with
``log = get_logger("scheduler")`` and emit ``log.info("schedule",
gang=g, slice=sid)``.
"""

from __future__ import annotations

import io
import json
import logging
import sys


# Library etiquette: without this, an unconfigured tree leaks WARNING+
# events to stderr as bare text via logging.lastResort (fields dropped).
# configure() attaches the real JSON handler when logging is opted into.
logging.getLogger("kubetpu").addHandler(logging.NullHandler())


class JsonFormatter(logging.Formatter):
    """One JSON object per record; event fields ride in ``record.fields``."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 6),
            "level": record.levelname.lower(),
            "component": record.name.removeprefix("kubetpu."),
            "event": record.getMessage(),
        }
        out.update(getattr(record, "fields", {}))
        if record.exc_info and record.exc_info[0] is not None:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


class StructuredLogger:
    """Thin wrapper giving ``log.info(event, **fields)`` ergonomics over a
    stdlib logger (stdlib wants printf args, not field dicts)."""

    def __init__(self, logger: logging.Logger):
        self._logger = logger

    def _emit(self, level: int, event: str, fields: dict) -> None:
        if self._logger.isEnabledFor(level):
            self._logger.log(level, event, extra={"fields": fields})

    def debug(self, event: str, **fields) -> None:
        self._emit(logging.DEBUG, event, fields)

    def info(self, event: str, **fields) -> None:
        self._emit(logging.INFO, event, fields)

    def warning(self, event: str, **fields) -> None:
        self._emit(logging.WARNING, event, fields)

    def error(self, event: str, **fields) -> None:
        self._emit(logging.ERROR, event, fields)


def get_logger(component: str) -> StructuredLogger:
    """Logger for one component (``scheduler``, ``crishim``, ...)."""
    return StructuredLogger(logging.getLogger(f"kubetpu.{component}"))


def configure(level: int = logging.INFO,
              stream: io.TextIOBase | None = None) -> logging.Handler:
    """JSON-lines handler on the ``kubetpu`` root (idempotent: replaces a
    previously configured one).  Returns the handler so tests/CLIs can
    detach or point it at a file."""
    root = logging.getLogger("kubetpu")
    for h in list(root.handlers):
        if getattr(h, "_kubetpu_json", False):
            root.removeHandler(h)
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(JsonFormatter())
    handler._kubetpu_json = True
    root.addHandler(handler)
    root.setLevel(level)
    root.propagate = False
    return handler


__all__ = ["JsonFormatter", "StructuredLogger", "get_logger", "configure"]
