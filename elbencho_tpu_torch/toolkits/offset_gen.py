"""Offset generators for the block I/O loop.

Reference: source/toolkits/offsetgen/OffsetGenerator.h (Sequential :48,
RandomAligned :252) and OffsetGenRandomAlignedFullCoverageV2.h (LCG
permutation over block indices, power-of-2 modulus — the default for
aligned random *writes* so every block is hit exactly once).

Each generator yields (offset, length) pairs; the sequences are the JAX
package's, so a file written by one package reads back under the other.
"""

from __future__ import annotations

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
