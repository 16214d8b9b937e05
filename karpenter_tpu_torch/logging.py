"""Structured JSON logging with change-deduplication.

Copy of karpenter_tpu/logging.py. The reference logs zap JSON and
suppresses repeat messages with a ChangeMonitor; this module is that
pattern over the stdlib, under the JAX package's logger root
(``karpenter``), so both packages' lines land in one stream:

    log = get_logger("solver")
    log.warning("convex rounding failed; tick stays on FFD", error="...")

emits one JSON object per line on stderr, and a ChangeMonitor keyed by
any hashable value logs only on change (TorchSolver's ``_route_monitor``
logs each degrade rung once per change of its exception type):

    if MONITOR.has_changed("convex_round", type(e).__name__):
        log.warning(...)
"""
from __future__ import annotations

import json
import logging
import sys
import threading
import time
from typing import Any, Dict

ROOT = "karpenter"

_RESERVED = set(
    "name msg args asctime levelname levelno pathname filename module exc_info "
    "exc_text stack_info lineno funcName created msecs relativeCreated "
    "thread threadName processName process taskName message".split()
)


class JSONFormatter(logging.Formatter):
    """One JSON object per record; every non-reserved record attribute
    (the kwargs of StructuredAdapter) becomes a top-level field."""

    def format(self, record: logging.LogRecord) -> str:
        doc: Dict[str, Any] = {
            "ts": round(record.created, 3),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        for key, value in record.__dict__.items():
            if key in _RESERVED or key.startswith("_"):
                continue
            try:
                json.dumps(value)
                doc[key] = value
            except (TypeError, ValueError):
                doc[key] = repr(value)
        if record.exc_info:
            doc["exc"] = self.formatException(record.exc_info)
        return json.dumps(doc, default=repr)


class StructuredAdapter(logging.LoggerAdapter):
    """kwargs become JSON fields: log.info("msg", nodepool="x", pods=3)."""

    def _log_kw(self, level: int, msg: str, fields: Dict[str, Any]) -> None:
        if self.logger.isEnabledFor(level):
            # LogRecord refuses extras that shadow its own attributes
            # (KeyError at the call site); prefix collisions instead
            safe = {
                (f"field_{k}" if k in _RESERVED else k): v for k, v in fields.items()
            }
            self.logger.log(level, msg, extra=safe)

    def debug(self, msg: str, **fields):
        self._log_kw(logging.DEBUG, msg, fields)

    def info(self, msg: str, **fields):
        self._log_kw(logging.INFO, msg, fields)

    def warning(self, msg: str, **fields):
        self._log_kw(logging.WARNING, msg, fields)

    def error(self, msg: str, **fields):
        self._log_kw(logging.ERROR, msg, fields)


_configured = False
_config_lock = threading.Lock()


def configure(stream=None, level: int = logging.INFO) -> None:
    """Install the JSON handler on the root framework logger (idempotent;
    re-running replaces the handler -- tests use this to capture output)."""
    global _configured
    with _config_lock:
        root = logging.getLogger(ROOT)
        for h in list(root.handlers):
            root.removeHandler(h)
        handler = logging.StreamHandler(stream or sys.stderr)
        handler.setFormatter(JSONFormatter())
        root.addHandler(handler)
        root.setLevel(level)
        root.propagate = False
        _configured = True


def get_logger(name: str) -> StructuredAdapter:
    if not _configured:
        configure()
    return StructuredAdapter(logging.getLogger(f"{ROOT}.{name}"), {})


class ChangeMonitor:
    """Log-suppression by value change (reference: operatorpkg ChangeMonitor
    used throughout the providers): has_changed(key, value) is True only
    when `value` differs from the last one seen for `key`, or the entry
    is older than the TTL (so long-lived steady state still re-logs
    occasionally, as the reference's 24h default does)."""

    def __init__(self, ttl_seconds: float = 24 * 3600.0, clock=None):
        self.ttl = ttl_seconds
        self._clock = clock  # injectable for tests; None = wall time
        self._last: Dict[Any, tuple] = {}
        self._lock = threading.Lock()

    def _now(self) -> float:
        return self._clock.now() if self._clock is not None else time.time()

    def has_changed(self, key: Any, value: Any) -> bool:
        now = self._now()
        with self._lock:
            prev = self._last.get(key)
            if prev is not None and prev[0] == value and now - prev[1] < self.ttl:
                return False
            self._last[key] = (value, now)
            return True
