"""File toolkit: the per-op byte-range lock of ``--flock``.

Reference: elbencho_tpu/toolkits/file_tk.py (source/toolkits/
FileTk.{h,cpp}, the flock templates). The tree scan and the tree file
writer come with the custom trees (ROADMAP.md queue A).
"""

from __future__ import annotations

import fcntl


class FileRangeLock:
    """POSIX advisory byte-range lock around one I/O op: exclusive for a
    write, shared for a read; ``full`` locks the whole file (length 0 at
    offset 0), ``range`` the op's bytes."""

    def __init__(self, fd: int, mode: str, offset: int, length: int,
                 is_write: bool):
        self.fd = fd
        self.is_write = is_write
        if mode == "full":
            self.offset, self.length = 0, 0  # 0 length = whole file
        else:
            self.offset, self.length = offset, length

    def __enter__(self):
        fcntl.lockf(self.fd, fcntl.LOCK_EX if self.is_write
                    else fcntl.LOCK_SH, self.length, self.offset, 0)
        return self

    def __exit__(self, *exc):
        fcntl.lockf(self.fd, fcntl.LOCK_UN, self.length, self.offset, 0)
        return False
