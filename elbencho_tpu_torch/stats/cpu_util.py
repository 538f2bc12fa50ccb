"""CPU utilization from /proc/stat deltas between update() calls.

Reference: source/CPUUtil.{h,cpp}; brackets each benchmark phase
(stonewall + last-done snapshots).
"""

from __future__ import annotations


class CPUUtil:
    def __init__(self):
        self._last_busy = 0
        self._last_total = 0

    @staticmethod
    def _read_proc_stat() -> "tuple[int, int]":
        try:
            with open("/proc/stat", "r") as f:
                fields = f.readline().split()[1:]
            vals = [int(v) for v in fields]
        except (OSError, ValueError, IndexError):
            return (0, 0)
        idle = vals[3] + (vals[4] if len(vals) > 4 else 0)  # idle + iowait
        total = sum(vals)
        return (total - idle, total)

    def update(self) -> float:
        """Utilization percentage over the interval since last update."""
        busy, total = self._read_proc_stat()
        d_busy = busy - self._last_busy
        d_total = total - self._last_total
        self._last_busy, self._last_total = busy, total
        return (100.0 * d_busy / d_total) if d_total > 0 else 0.0
