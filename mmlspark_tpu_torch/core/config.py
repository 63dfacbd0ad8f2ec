"""Runtime configuration: the port's copy of ``mmlspark_tpu/core/config.py``
(ref: src/core/env/src/main/scala/Configuration.scala:18-51).

Two-layer config like the reference's Typesafe-config `mmlspark.*` namespace:
defaults < config file (json) < environment (`MMLSPARK_TPU_<KEY>`).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional

_ENV_PREFIX = "MMLSPARK_TPU_"

_DEFAULTS: Dict[str, Any] = {
    "cache_dir": os.path.expanduser("~/.mmlspark_tpu"),
    "model_zoo_dir": os.path.expanduser("~/.mmlspark_tpu/models"),
    "log_level": "INFO",
    # 'text' (human console) | 'json' (one-line structured records
    # carrying trace_id/model_version when emitted inside a span)
    "log_format": "text",
    # request/training tracing (core.trace): master switch, completed-
    # trace ring capacity, tail-sampling slow percentile, and the head
    # sample rate for bulk (non-error, non-slow) traces
    "trace.enabled": True,
    "trace.capacity": 256,
    "trace.slow_percentile": 90.0,
    "trace.sample_rate": 1.0,
    "serving.port": 8899,
    "serving.host": "0.0.0.0",
    "http.concurrency": 8,
    "http.timeout_sec": 60.0,
    "gbdt.default_bins": 255,
    "mesh.data_axis": "data",
    "mesh.model_axis": "model",
}

_lock = threading.Lock()
_overrides: Dict[str, Any] = {}


def _from_env(key: str) -> Optional[str]:
    env_key = _ENV_PREFIX + key.upper().replace(".", "_")
    return os.environ.get(env_key)


def load_config_file(path: str) -> None:
    with open(path) as f:
        data = json.load(f)
    with _lock:
        _overrides.update(data)


def get(key: str, default: Any = None) -> Any:
    env = _from_env(key)
    if env is not None:
        # coerce to the known value's type: overrides/defaults, else the
        # caller-supplied default
        with _lock:
            base = _overrides.get(key, _DEFAULTS.get(key, default))
        if isinstance(base, bool):
            return env.lower() in ("1", "true", "yes")
        if isinstance(base, int):
            return int(env)
        if isinstance(base, float):
            return float(env)
        return env
    with _lock:
        if key in _overrides:
            return _overrides[key]
    return _DEFAULTS.get(key, default)


def set_config(key: str, value: Any) -> None:
    with _lock:
        _overrides[key] = value


def all_config() -> Dict[str, Any]:
    out = dict(_DEFAULTS)
    with _lock:
        out.update(_overrides)
    return out
