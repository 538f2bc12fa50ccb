"""Timestamped console logger (reference: source/Logger.{h,cpp}).

The port's slice has no --log flag, so every message is at the normal
level; errors go to stderr.
"""

from __future__ import annotations

import sys
import threading
import time

LOG_NORMAL = 0

_lock = threading.Lock()


def log(level: int, message: str) -> None:
    if level > LOG_NORMAL:
        return
    ts = time.strftime("%Y-%m-%d %H:%M:%S")
    with _lock:
        print(f"{ts} {message}", flush=True)


def log_error(message: str) -> None:
    ts = time.strftime("%Y-%m-%d %H:%M:%S")
    with _lock:
        print(f"{ts} ERROR: {message}", file=sys.stderr, flush=True)
