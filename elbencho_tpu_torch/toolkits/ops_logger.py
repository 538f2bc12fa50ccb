"""Per-operation JSONL trace (``--opslog``).

Reference: elbencho_tpu/toolkits/ops_logger.py (source/toolkits/
OpsLogger.{h,cpp}): one JSON line per record with date, worker_rank,
op_name, entry_name, offset, length, is_finished and is_error; a pre
record and a post record around each dir-mode entry, one completion
record per block; an optional flock around each line for a log file that
several processes share (``--opsloglock``). The native engine writes the
block records of its loop itself, through ``fd``, with the same keys.
"""

from __future__ import annotations

import fcntl
import json
import os
import time


class OpsLogger:
    def __init__(self, path: str, worker_rank: int, use_lock: bool = False):
        self.worker_rank = worker_rank
        self.use_lock = use_lock
        self._fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                           0o644)

    @property
    def fd(self) -> int:
        """Raw fd for the native engine's in-loop block records."""
        return self._fd

    def _write(self, record: dict) -> None:
        line = (json.dumps(record, separators=(",", ":")) + "\n").encode()
        if self.use_lock:
            fcntl.flock(self._fd, fcntl.LOCK_EX)
            try:
                os.write(self._fd, line)
            finally:
                fcntl.flock(self._fd, fcntl.LOCK_UN)
        else:
            os.write(self._fd, line)

    def _record(self, op_name: str, entry_name: str, offset: int,
                length: int, is_finished: bool, is_error: bool) -> dict:
        return {
            "date": time.strftime("%Y%m%dT%H%M%S")
            + f".{time.time_ns() % 1_000_000_000:09d}",
            "worker_rank": self.worker_rank,
            "op_name": op_name,
            "entry_name": entry_name,
            "offset": offset,
            "length": length,
            "is_finished": is_finished,
            "is_error": is_error,
        }

    def log_op_pre(self, op_name: str, entry_name: str = "",
                   offset: int = 0, length: int = 0) -> None:
        self._write(self._record(op_name, entry_name, offset, length,
                                 is_finished=False, is_error=False))

    def log_op(self, op_name: str, entry_name: str = "", offset: int = 0,
               length: int = 0, is_error: bool = False) -> None:
        self._write(self._record(op_name, entry_name, offset, length,
                                 is_finished=True, is_error=is_error))

    def logged_op(self, op_name: str, entry_name: str = "",
                  offset: int = 0, length: int = 0) -> "_LoggedOp":
        """Context manager writing the pre record on entry and the post
        record on exit, with is_error=True when the body raises or sets
        ``ctx.error = True`` (a failure it tolerates)."""
        return _LoggedOp(self, op_name, entry_name, offset, length)

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1


class _LoggedOp:
    __slots__ = ("_logger", "_args", "error")

    def __init__(self, logger: "OpsLogger | None", op_name: str,
                 entry_name: str, offset: int, length: int):
        self._logger = logger
        self._args = (op_name, entry_name, offset, length)
        self.error = False

    def __enter__(self) -> "_LoggedOp":
        if self._logger is not None:
            self._logger.log_op_pre(*self._args)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._logger is not None:
            self._logger.log_op(*self._args,
                                is_error=self.error or exc_type is not None)
        return False


def null_logged_op(*_args, **_kwargs) -> _LoggedOp:
    """The no-op context of a worker without --opslog."""
    return _LoggedOp(None, "", "", 0, 0)
