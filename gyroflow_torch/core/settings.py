"""Persistent JSON settings store.

Port of gyroflow src/core/settings.rs: key-value JSON file in the data
dir with typed getters.
"""
from __future__ import annotations

import json
import logging
import os
import threading
from typing import Any, Optional

log = logging.getLogger(__name__)

_lock = threading.Lock()


def data_dir() -> str:
    d = os.environ.get("GYROFLOW_TPU_DATA_DIR") or \
        os.path.join(os.path.expanduser("~"), ".config", "gyroflow-tpu")
    os.makedirs(d, exist_ok=True)
    return d


def _settings_path() -> str:
    return os.path.join(data_dir(), "settings.json")


def _load() -> dict:
    try:
        with open(_settings_path()) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}


def get(key: str, default: Any = None) -> Any:
    with _lock:
        return _load().get(key, default)


def set(key: str, value: Any):  # noqa: A001 — mirrors settings.rs API
    with _lock:
        d = _load()
        d[key] = value
        tmp = _settings_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(d, f, indent=2)
        os.replace(tmp, _settings_path())


def get_bool(key: str, default: bool = False) -> bool:
    v = get(key, default)
    return bool(v)


def get_f64(key: str, default: float = 0.0) -> float:
    try:
        return float(get(key, default))
    except (TypeError, ValueError):
        return default


def get_str(key: str, default: str = "") -> str:
    v = get(key, default)
    return str(v) if v is not None else default


def clear():
    with _lock:
        try:
            os.remove(_settings_path())
        except OSError:
            pass
