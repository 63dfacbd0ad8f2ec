"""Namespaced logging: the port's copy of
``mmlspark_tpu/core/logging_utils.py``.

Loggers are namespaced ``mmlspark_tpu_torch.<subspace>``, beside the JAX
package's ``mmlspark_tpu.<subspace>``, so a process holding both keeps
their records apart.

``log_format=json`` (via ``core.config`` / ``MMLSPARK_TPU_LOG_FORMAT``)
switches every handler to one-line JSON records. The reference adds the
active span's ``trace_id``/``span_id`` to each; the port has no request
tracing yet (ROADMAP.md, 'Device pipeline and serving compilation'), so
its records carry none.
"""

from __future__ import annotations

import json
import logging
import time

_ROOT = "mmlspark_tpu_torch"
_configured = False


class JsonFormatter(logging.Formatter):
    """One-line JSON log records."""

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
