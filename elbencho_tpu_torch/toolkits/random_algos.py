"""The "fast" PRNG tier (reference: source/toolkits/random/RandAlgoGoldenPrime.h).

Golden-prime multiplicative generator with weak randomness that reseeds
from Mersenne Twister every 256 KiB of output. The port uses it for random
offsets (``--rand``) and for pre-filling the staging slots, exactly as the
JAX package does (its ``create_rand_algo("fast", ...)``).
"""

from __future__ import annotations

import random as _pyrandom

import numpy as np

_MASK64 = (1 << 64) - 1
_GOLDEN_PRIME = 0x9E3779B97F4A7C15
_GOLDEN_RESEED_BYTES = 256 * 1024


def _rotl(x: int, k: int) -> int:
    return ((x << k) | (x >> (64 - k))) & _MASK64


class RandAlgoGoldenPrime:
    """next64() -> int in [0, 2^64); next64_batch(n) -> the same sequence
    as a uint64 array; fill_buffer(n) -> bytes."""

    name = "fast"

    def __init__(self, seed: "int | None" = None):
        self._reseed_src = _pyrandom.Random(seed)
        self._state = self._reseed_src.getrandbits(64) | 1
        self._bytes_since_reseed = 0

    def next64(self) -> int:
        self._bytes_since_reseed += 8
        if self._bytes_since_reseed >= _GOLDEN_RESEED_BYTES:
            self._state = self._reseed_src.getrandbits(64) | 1
            self._bytes_since_reseed = 0
        self._state = (self._state * _GOLDEN_PRIME) & _MASK64
        return _rotl(self._state, 32)

    _prime_powers: "np.ndarray | None" = None  # prime^(i+1), shared table

    def next64_batch(self, n: int) -> np.ndarray:
        """Closed-form batch: state_i = state0 * prime^i (mod 2^64), so a
        precomputed power table yields the EXACT scalar sequence in one
        vector multiply (reseed boundaries handled per sub-batch)."""
        cls = type(self)
        if cls._prime_powers is None:
            # write-once table, so sharing it between threads is safe
            size = _GOLDEN_RESEED_BYTES // 8
            powers = np.empty(size, dtype=np.uint64)
            acc = 1
            for i in range(size):
                acc = (acc * _GOLDEN_PRIME) & _MASK64
                powers[i] = acc
            cls._prime_powers = powers
        out = np.empty(n, dtype=np.uint64)
        filled = 0
        with np.errstate(over="ignore"):
            while filled < n:
                # scalar semantics: the call whose counter reaches the
                # limit reseeds first, so from the current state we may
                # draw exactly (calls-until-trigger - 1) values
                trigger = (_GOLDEN_RESEED_BYTES
                           - self._bytes_since_reseed + 7) // 8
                if trigger <= 1:
                    out[filled] = self.next64()  # the reseeding call
                    filled += 1
                    continue
                k = min(n - filled, trigger - 1)
                states = np.uint64(self._state) * cls._prime_powers[:k]
                out[filled:filled + k] = \
                    (states << np.uint64(32)) | (states >> np.uint64(32))
                self._state = int(states[-1])
                self._bytes_since_reseed += 8 * k
                filled += k
        return out

    def fill_buffer(self, num_bytes: int) -> bytes:
        n = (num_bytes + 7) // 8
        return self.next64_batch(n).tobytes()[:num_bytes]
