"""File toolkit: the per-op byte-range lock of ``--flock``, and the
directory-tree scan and tree file writer of ``--treescan``.

Reference: elbencho_tpu/toolkits/file_tk.py (source/toolkits/
FileTk.{h,cpp}, the flock templates, and tools/elbencho-scan-path).
"""

from __future__ import annotations

import base64
import fcntl
import os

from .path_store import TREEFILE_BASE64_HEADER, PathStore


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


def scan_tree(root: str) -> "tuple[PathStore, PathStore, bool]":
    """Walk a real directory tree into (dirs, files, needs_base64): a
    name with a newline needs the base64 tree file."""
    dirs = PathStore()
    files = PathStore()
    needs_b64 = False
    root = root.rstrip("/")
    for dirpath, _dirnames, filenames in os.walk(root):
        rel_dir = os.path.relpath(dirpath, root)
        if rel_dir != ".":
            dirs.load_dirs_from_text(f"d {rel_dir}")
            if "\n" in rel_dir:
                needs_b64 = True
        for name in filenames:
            full = os.path.join(dirpath, name)
            rel = os.path.relpath(full, root)
            try:
                size = os.stat(full).st_size
            except OSError:
                continue
            if "\n" in rel:
                needs_b64 = True
            files.load_files_from_text(f"f {size} {rel}")
    return dirs, files, needs_b64


def write_treefile(out_path: str, dirs: PathStore, files: PathStore,
                   use_base64: bool = False) -> None:
    with open(out_path, "w", encoding="utf-8",
              errors="surrogateescape") as f:
        if use_base64:
            f.write(TREEFILE_BASE64_HEADER + "\n")

            def enc(s: str) -> str:
                return base64.b64encode(
                    s.encode("utf-8", errors="surrogateescape")).decode()
        else:
            def enc(s: str) -> str:
                return s
        for elem in dirs.elems:
            f.write(f"d {enc(elem.path)}\n")
        for elem in files.elems:
            f.write(f"f {elem.total_len} {enc(elem.path)}\n")
