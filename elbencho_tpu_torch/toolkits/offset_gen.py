"""Offset generators for the block I/O loop.

Reference: source/toolkits/offsetgen/OffsetGenerator.h (Sequential :48,
RandomAligned :252) and OffsetGenRandomAlignedFullCoverageV2.h (LCG
permutation over block indices, power-of-2 modulus — the default for
aligned random *writes* so every block is hit exactly once).

Each generator yields (offset, length) pairs, or hands out up to max_n
of them at once as uint64 arrays (``next_batch``, which feeds the native
engine); the sequences are the JAX package's, so a file written by one
package reads back under the other.
"""

from __future__ import annotations

import numpy as np

from .random_algos import RandAlgoGoldenPrime


class OffsetGenerator:
    def next_block(self) -> "tuple[int, int] | None":
        raise NotImplementedError

    def __iter__(self):
        while True:
            blk = self.next_block()
            if blk is None:
                return
            yield blk

    def next_batch(self, max_n: int):
        """Up to max_n blocks as (offsets, lengths) uint64 arrays, or None
        when exhausted: the sequence of next_block, in array math."""
        raise NotImplementedError

    @staticmethod
    def _batch_lens(max_n: int, remaining: int, block_size: int):
        """k full blocks, the last one short when remaining is not a
        multiple of the block size -> (k, lengths array)."""
        k = min(max_n, (remaining + block_size - 1) // block_size)
        lens = np.full(k, block_size, dtype=np.uint64)
        if k * block_size > remaining:
            lens[-1] = remaining - (k - 1) * block_size
        return k, lens


class OffsetGenSequential(OffsetGenerator):
    """Forward sequential over [start, start+num_bytes); final block may be
    short (reference: OffsetGenerator.h:48-104)."""

    def __init__(self, num_bytes: int, block_size: int, start: int = 0):
        if block_size <= 0:
            raise ValueError("block_size must be > 0")
        self.num_bytes = num_bytes
        self.block_size = block_size
        self.start = start
        self._pos = 0

    def next_block(self):
        if self._pos >= self.num_bytes:
            return None
        length = min(self.block_size, self.num_bytes - self._pos)
        off = self.start + self._pos
        self._pos += length
        return (off, length)

    def next_batch(self, max_n: int):
        if self._pos >= self.num_bytes:
            return None
        k, lens = self._batch_lens(max_n, self.num_bytes - self._pos,
                                   self.block_size)
        offs = (np.uint64(self.start + self._pos)
                + np.arange(k, dtype=np.uint64) * np.uint64(self.block_size))
        self._pos += int(lens.sum())
        return offs, lens


class OffsetGenRandomAligned(OffsetGenerator):
    """Block-aligned uniform-random offsets (may repeat/miss blocks)
    (reference: OffsetGenerator.h:252-321)."""

    def __init__(self, rand: RandAlgoGoldenPrime, num_bytes: int,
                 block_size: int, range_len: int):
        if block_size <= 0:
            raise ValueError("block_size must be > 0")
        if range_len < block_size:
            raise ValueError("range smaller than block size")
        self.rand = rand
        self.num_bytes = num_bytes
        self.block_size = block_size
        self.num_blocks_in_range = range_len // block_size
        self._bytes_left = num_bytes

    def next_block(self):
        if self._bytes_left <= 0:
            return None
        length = min(self.block_size, self._bytes_left)
        blk = self.rand.next64() % self.num_blocks_in_range
        self._bytes_left -= length
        return (blk * self.block_size, length)

    def next_batch(self, max_n: int):
        if self._bytes_left <= 0:
            return None
        k, lens = self._batch_lens(max_n, self._bytes_left, self.block_size)
        blks = self.rand.next64_batch(k) % np.uint64(self.num_blocks_in_range)
        self._bytes_left -= int(lens.sum())
        return blks * np.uint64(self.block_size), lens


class OffsetGenRandomAlignedFullCoverage(OffsetGenerator):
    """Aligned random permutation hitting every block exactly once.

    An LCG with power-of-2 modulus m >= num_blocks; with c odd and
    a % 4 == 1 it is full-period (Hull-Dobell), so iterating it visits
    every value in [0, m) exactly once; values >= num_blocks are skipped.
    """

    def __init__(self, rand: RandAlgoGoldenPrime, num_bytes: int,
                 block_size: int, range_len: int):
        if block_size <= 0:
            raise ValueError("block_size must be > 0")
        self.num_bytes = num_bytes
        self.block_size = block_size
        self.num_blocks = max(1, range_len // block_size)
        self._m = 1
        while self._m < self.num_blocks:
            self._m <<= 1
        self._mask = self._m - 1
        self._a = ((rand.next64() << 2) | 1) & self._mask
        if self._a % 4 != 1:
            self._a = (self._a + 2) & self._mask  # force a % 4 == 1
        if self._m >= 4 and self._a % 4 != 1:
            self._a = 5
        self._c = (rand.next64() | 1) & self._mask  # odd
        self._x = rand.next64() & self._mask
        self._bytes_left = num_bytes
        self._emitted = 0

    def next_block(self):
        if self._bytes_left <= 0:
            return None
        # advance the LCG until a value < num_blocks appears (wraps if the
        # generator is asked for more than one full coverage)
        while True:
            if self._emitted >= self._m:  # completed a full period
                self._emitted = 0
            self._x = (self._a * self._x + self._c) & self._mask
            self._emitted += 1
            if self._x < self.num_blocks:
                break
        length = min(self.block_size, self._bytes_left)
        self._bytes_left -= length
        return (self._x * self.block_size, length)

    _JUMP = 4096  # raw LCG steps per vectorized advance
    _jump_a = None

    def _ensure_jump_tables(self) -> None:
        """A[i] = a^(i+1) mod m and C[i] = c*(a^i + ... + 1) mod m, so
        x_{n+i+1} = A[i]*x_n + C[i]: one vector op yields _JUMP successive
        raw LCG states (the same exactly-once sequence as next_block)."""
        if self._jump_a is not None:
            return
        a_tab = np.empty(self._JUMP, dtype=np.uint64)
        c_tab = np.empty(self._JUMP, dtype=np.uint64)
        a_acc, c_acc = self._a, self._c
        for i in range(self._JUMP):
            a_tab[i] = a_acc
            c_tab[i] = c_acc
            a_acc = (a_acc * self._a) & self._mask
            c_acc = (c_acc * self._a + self._c) & self._mask
        self._jump_a, self._jump_c = a_tab, c_tab

    def next_batch(self, max_n: int):
        if self._bytes_left <= 0:
            return None
        self._ensure_jump_tables()
        k, lens = self._batch_lens(max_n, self._bytes_left, self.block_size)
        blks = np.empty(k, dtype=np.uint64)
        filled = 0
        mask = np.uint64(self._mask)
        with np.errstate(over="ignore"):
            while filled < k:
                # raw candidates, never across a period boundary at once
                take = min(self._JUMP, self._m - self._emitted)
                cand = (self._jump_a[:take] * np.uint64(self._x)
                        + self._jump_c[:take]) & mask
                good = np.nonzero(cand < self.num_blocks)[0]
                need = k - filled
                if len(good) > need:
                    # stop at the raw step of the last value emitted, so
                    # next_block resumes mid-stream identically
                    consumed = int(good[need - 1]) + 1
                    good = good[:need]
                else:
                    consumed = take
                blks[filled:filled + len(good)] = cand[good]
                filled += len(good)
                if consumed:
                    self._x = int(cand[consumed - 1])
                    self._emitted += consumed
                if self._emitted >= self._m:
                    self._emitted = 0
        self._bytes_left -= int(lens.sum())
        return blks * np.uint64(self.block_size), lens
