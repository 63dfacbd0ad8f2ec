"""Namespaced logging: the port's copy of
``mmlspark_tpu/core/logging_utils.py``.

Loggers are namespaced ``mmlspark_tpu_torch.<subspace>``, beside the JAX
package's ``mmlspark_tpu.<subspace>``, so a process holding both keeps
their records apart.

``log_format=json`` (via ``core.config`` / ``MMLSPARK_TPU_LOG_FORMAT``)
switches every handler to one-line JSON records that carry the active
span's ``trace_id``/``span_id`` (and ``model_version`` when the span
has one), so logs join traces on trace_id instead of timestamps.
"""

from __future__ import annotations

import json
import logging
import time

_ROOT = "mmlspark_tpu_torch"
_configured = False


class JsonFormatter(logging.Formatter):
    """One-line JSON log records, trace-correlated: when the emitting
    context holds an active span (``core.trace.use_span``), the record
    carries its trace_id/span_id and the span's model_version attr."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 6),
            "time": time.strftime(
                "%Y-%m-%dT%H:%M:%S", time.gmtime(record.created))
            + f".{int(record.msecs):03d}Z",
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        try:
            from mmlspark_tpu_torch.core.trace import current_span
            span = current_span()
        except Exception:  # noqa: BLE001 — logging must never raise
            span = None
        if span is not None:
            out["trace_id"] = span.trace_id
            out["span_id"] = span.span_id
            version = span.attrs.get("model_version")
            if version is not None:
                out["model_version"] = version
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


def _make_formatter(fmt: str) -> logging.Formatter:
    if str(fmt).lower() == "json":
        return JsonFormatter()
    return logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s")


def configure(force: bool = False) -> None:
    """(Re-)apply level + format from ``core.config``. Idempotent; pass
    ``force=True`` after changing ``log_format``/``log_level`` at
    runtime (``config.set_config``) to re-read them."""
    global _configured
    if _configured and not force:
        return
    from mmlspark_tpu_torch.core import config
    root = logging.getLogger(_ROOT)
    if not root.handlers:
        handler = logging.StreamHandler()
        handler._mmlspark_tpu_torch_owned = True
        root.addHandler(handler)
    formatter = _make_formatter(config.get("log_format", "text"))
    for handler in root.handlers:
        # only restyle handlers this module created: an embedding app's
        # own handlers (and formatters) on the mmlspark_tpu_torch logger are
        # its business
        if getattr(handler, "_mmlspark_tpu_torch_owned", False):
            handler.setFormatter(formatter)
    level = config.get("log_level", "INFO")  # env wins inside config.get
    root.setLevel(getattr(logging, str(level).upper(), logging.INFO))
    root.propagate = False
    _configured = True


def _ensure_configured():
    configure(force=False)


def get_logger(subspace: str = "") -> logging.Logger:
    _ensure_configured()
    name = f"{_ROOT}.{subspace}" if subspace else _ROOT
    return logging.getLogger(name)
