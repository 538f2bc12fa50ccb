"""PathStore: custom-tree file lists and the worker sublist math.

Reference: elbencho_tpu/toolkits/path_store.py (source/PathStore.{h,cpp}).
A tree file holds "d <path>" directory lines and "f <size> <path>" file
lines, '#' comments, and optionally a "# encoding=base64" header so that
names with newlines survive. ``--sharesize`` splits the files into a
non-shared set (whole files, spread over the workers by size) and a
shared set (cut into block-granular ranges: contiguous, or round robin
under ``--treeroundrob``).
"""

from __future__ import annotations

import base64
import random
from dataclasses import dataclass, field

TREEFILE_COMMENT_CHAR = "#"
TREEFILE_BASE64_HEADER = "# encoding=base64"
DIR_LINE_PREFIX = "d"
FILE_LINE_PREFIX = "f"


@dataclass
class PathStoreElem:
    path: str
    total_len: int = 0      # total size of the file
    range_start: int = 0    # slice offset (shared files)
    range_len: int = 0      # slice length (shared files)


@dataclass
class PathStore:
    elems: "list[PathStoreElem]" = field(default_factory=list)
    block_size: int = 1

    # -- loading ------------------------------------------------------------

    @staticmethod
    def _treefile_is_base64(text: str) -> bool:
        for line in text.splitlines():
            if line.startswith(TREEFILE_BASE64_HEADER):
                return True
            if line and not line.startswith(TREEFILE_COMMENT_CHAR):
                break
        return False

    @staticmethod
    def _decode_name(name: str, is_b64: bool) -> str:
        if not is_b64:
            return name
        return base64.b64decode(name).decode("utf-8", errors="surrogateescape")

    def load_dirs_from_text(self, text: str) -> None:
        """Parse "d <relative_path>" lines; others are ignored."""
        is_b64 = self._treefile_is_base64(text)
        for line in text.splitlines():
            parts = line.split(maxsplit=1)
            if len(parts) != 2 or parts[0] != DIR_LINE_PREFIX:
                continue
            self.elems.append(PathStoreElem(self._decode_name(parts[1],
                                                              is_b64)))

    def load_files_from_text(self, text: str, min_size: int = 0,
                             max_size: "int | None" = None,
                             round_up_size: int = 0) -> None:
        """Parse "f <size_in_bytes> <relative_path>" lines, with a size
        filter and an optional round-up of each size."""
        is_b64 = self._treefile_is_base64(text)
        for line in text.splitlines():
            parts = line.split(maxsplit=2)
            if len(parts) != 3 or parts[0] != FILE_LINE_PREFIX:
                continue
            size = int(parts[1])
            if size < min_size or (max_size is not None and size > max_size):
                continue
            if round_up_size and size % round_up_size:
                size += round_up_size - (size % round_up_size)
            self.elems.append(PathStoreElem(
                self._decode_name(parts[2], is_b64), total_len=size,
                range_start=0, range_len=size))

    def load_files_from_file(self, path: str, min_size: int = 0,
                             max_size: "int | None" = None,
                             round_up_size: int = 0) -> None:
        with open(path, "r", encoding="utf-8", errors="surrogateescape") as f:
            self.load_files_from_text(f.read(), min_size, max_size,
                                      round_up_size)

    # -- ordering -----------------------------------------------------------

    def sort_by_path_len(self) -> None:
        self.elems.sort(key=lambda e: (len(e.path), e.path))

    def random_shuffle(self, seed: "int | None" = None) -> None:
        """The standard library's shuffle: one seed gives one order on
        every host (the JAX package's order too)."""
        random.Random(seed).shuffle(self.elems)

    # -- worker sublists ----------------------------------------------------

    def get_worker_sublist_non_shared(self, worker_rank: int,
                                      num_dataset_threads: int) -> "PathStore":
        """Whole files, each to the least-loaded worker (by bytes, ties to
        the lower rank), biggest first; the worker's files in path
        order."""
        loads = [0] * num_dataset_threads
        out = PathStore(block_size=self.block_size)
        order = sorted(range(len(self.elems)),
                       key=lambda i: (-self.elems[i].total_len, i))
        for i in order:
            tgt = min(range(num_dataset_threads), key=lambda r: (loads[r], r))
            loads[tgt] += max(self.elems[i].total_len, 1)
            if tgt == worker_rank:
                out.elems.append(self.elems[i])
        out.elems.sort(key=lambda e: e.path)
        return out

    def get_worker_sublist_shared(self, worker_rank: int,
                                  num_dataset_threads: int) -> "PathStore":
        """Block-granular contiguous slices: the store's blocks are divided
        evenly, and each worker's contiguous run of blocks maps to
        (possibly partial) per-file ranges."""
        bs = self.block_size
        file_blocks = [max(1, (e.total_len + bs - 1) // bs) for e in self.elems]
        total_blocks = sum(file_blocks)
        base, rem = divmod(total_blocks, num_dataset_threads)
        start_block = worker_rank * base + min(worker_rank, rem)
        my_blocks = base + (1 if worker_rank < rem else 0)
        end_block = start_block + my_blocks

        out = PathStore(block_size=bs)
        cursor = 0
        for elem, nblocks in zip(self.elems, file_blocks):
            file_start, file_end = cursor, cursor + nblocks
            cursor = file_end
            lo = max(start_block, file_start)
            hi = min(end_block, file_end)
            if lo >= hi:
                continue
            range_start = (lo - file_start) * bs
            range_len = min((hi - lo) * bs, elem.total_len - range_start)
            out.elems.append(PathStoreElem(elem.path, elem.total_len,
                                           range_start, range_len))
        return out

    def get_worker_sublist_shared_round_robin(self, worker_rank: int,
                                              num_dataset_threads: int
                                              ) -> "PathStore":
        """Round-robin blocks (--treeroundrob): the worker takes each block
        whose global index modulo the dataset threads is its rank. Each
        file's element holds the worker's first block (range_start) and
        the bytes of all its blocks there (range_len), the file's short
        last block counted short; OffsetGenStrided reads them. The JAX
        package stores min(count * block, total_len - range_start) and
        reads it as one contiguous range, so it writes a shared file
        short (ROADMAP.md C)."""
        bs = self.block_size
        out = PathStore(block_size=bs)
        global_block = 0
        for elem in self.elems:
            nblocks = max(1, (elem.total_len + bs - 1) // bs)
            first = None
            range_len = 0
            for b in range(nblocks):
                if (global_block + b) % num_dataset_threads == worker_rank:
                    if first is None:
                        first = b
                    range_len += min(bs, elem.total_len - b * bs)
            global_block += nblocks
            if first is None:
                continue
            out.elems.append(PathStoreElem(elem.path, elem.total_len,
                                           first * bs, range_len))
        return out

    # -- misc ---------------------------------------------------------------

    def split_by_share_size(self, share_size: int
                            ) -> "tuple[PathStore, PathStore]":
        """(non_shared, shared): files >= share_size go to the shared
        (block-sliced) set."""
        non_shared = PathStore(block_size=self.block_size)
        shared = PathStore(block_size=self.block_size)
        for e in self.elems:
            (shared if e.total_len >= share_size else non_shared).elems.append(e)
        return non_shared, shared

    @property
    def num_paths(self) -> int:
        return len(self.elems)

    @property
    def total_bytes(self) -> int:
        return sum(e.range_len or e.total_len for e in self.elems)

