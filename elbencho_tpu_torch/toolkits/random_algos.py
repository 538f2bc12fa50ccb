"""The PRNG tiers (reference: source/toolkits/random/RandAlgo*.h).

The port's copy of elbencho_tpu/toolkits/random_algos.py, with the same
tiers (RandAlgoSelectorTk.h:12-24):
  strong           - MT19937 (RandAlgoMT19937.h)
  balanced_single  - xoshiro256** (RandAlgoXoshiro256ss.h)
  balanced         - xoshiro256++ over 8 lanes (RandAlgoXoshiro256ppSIMD.h),
                     vectorized with numpy for buffer fills
  fast             - golden-prime multiplicative generator with weak
                     randomness that reseeds from Mersenne Twister every
                     256 KiB of output (RandAlgoGoldenPrime.h)

"fast" serves random offsets (``--rand``) and the staging slots' pre-fill,
as in the JAX package; ``--blockvaralgo`` picks any tier for the
``--blockvarpct`` refill of the Python loop (the native engine has its
own "fast" tier).
"""

from __future__ import annotations

import random as _pyrandom

import numpy as np

_MASK64 = (1 << 64) - 1
_GOLDEN_PRIME = 0x9E3779B97F4A7C15
_GOLDEN_RESEED_BYTES = 256 * 1024


def _rotl(x: int, k: int) -> int:
    return ((x << k) | (x >> (64 - k))) & _MASK64


class RandAlgo:
    """Interface: next64() -> int in [0, 2^64); next64_batch(n) -> n
    draws as a uint64 array; fill_buffer(n) -> bytes."""

    name = "base"

    def next64(self) -> int:
        raise NotImplementedError

    def next64_batch(self, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.uint64)
        for i in range(n):
            out[i] = self.next64()
        return out

    def fill_buffer(self, num_bytes: int) -> bytes:
        out = bytearray()
        while len(out) < num_bytes:
            out += self.next64().to_bytes(8, "little")
        return bytes(out[:num_bytes])


class RandAlgoMT19937(RandAlgo):
    """'strong' tier: Mersenne Twister."""

    name = "strong"

    def __init__(self, seed: "int | None" = None):
        self._rng = _pyrandom.Random(seed)

    def next64(self) -> int:
        return self._rng.getrandbits(64)

    def fill_buffer(self, num_bytes: int) -> bytes:
        return self._rng.randbytes(num_bytes)


def _splitmix64_stream(seed: int, n: int) -> "list[int]":
    out = []
    state = seed & _MASK64
    for _ in range(n):
        state = (state + 0x9E3779B97F4A7C15) & _MASK64
        z = state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        out.append(z ^ (z >> 31))
    return out


class RandAlgoXoshiro256ss(RandAlgo):
    """'balanced_single' tier: xoshiro256** scalar."""

    name = "balanced_single"

    def __init__(self, seed: "int | None" = None):
        if seed is None:
            seed = _pyrandom.getrandbits(64)
        self._s = _splitmix64_stream(seed, 4)

    def next64(self) -> int:
        s = self._s
        result = (_rotl((s[1] * 5) & _MASK64, 7) * 9) & _MASK64
        t = (s[1] << 17) & _MASK64
        s[2] ^= s[0]
        s[3] ^= s[1]
        s[1] ^= s[2]
        s[0] ^= s[3]
        s[2] ^= t
        s[3] = _rotl(s[3], 45)
        return result


class RandAlgoXoshiro256pp(RandAlgo):
    """'balanced' tier: xoshiro256++ over LANES lanes; fill_buffer and
    next64_batch draw from the lane vectors, next64 from a scalar stream
    of its own (the reference's SIMD/scalar split)."""

    name = "balanced"
    LANES = 8

    def __init__(self, seed: "int | None" = None):
        if seed is None:
            seed = _pyrandom.getrandbits(64)
        states = _splitmix64_stream(seed, 4 * self.LANES)
        self._s = np.array(states, dtype=np.uint64).reshape(4, self.LANES)
        self._scalar = RandAlgoXoshiro256ss(seed)

    def next64(self) -> int:
        return self._scalar.next64()

    def _next_vec(self) -> np.ndarray:
        s = self._s
        with np.errstate(over="ignore"):
            tot = s[0] + s[3]
            result = ((tot << np.uint64(23)) | (tot >> np.uint64(41))) + s[0]
            t = s[1] << np.uint64(17)
            s[2] ^= s[0]
            s[3] ^= s[1]
            s[1] ^= s[2]
            s[0] ^= s[3]
            s[2] ^= t
            s[3] = (s[3] << np.uint64(45)) | (s[3] >> np.uint64(19))
        return result

    def _vecs(self, n_vecs: int) -> np.ndarray:
        chunks = np.empty((n_vecs, self.LANES), dtype=np.uint64)
        for i in range(n_vecs):
            chunks[i] = self._next_vec()
        return chunks

    def fill_buffer(self, num_bytes: int) -> bytes:
        n_vecs = (num_bytes + 8 * self.LANES - 1) // (8 * self.LANES)
        return self._vecs(n_vecs).tobytes()[:num_bytes]

    def next64_batch(self, n: int) -> np.ndarray:
        n_vecs = (n + self.LANES - 1) // self.LANES
        return self._vecs(n_vecs).reshape(-1)[:n]


class RandAlgoGoldenPrime(RandAlgo):
    """'fast' tier; next64_batch(n) gives the scalar sequence as a uint64
    array."""

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


RAND_ALGO_NAMES = ("strong", "balanced_single", "balanced", "fast")

_RAND_ALGOS = {"strong": RandAlgoMT19937,
               "balanced_single": RandAlgoXoshiro256ss,
               "balanced": RandAlgoXoshiro256pp,
               "fast": RandAlgoGoldenPrime}


def create_rand_algo(name: str, seed: "int | None" = None) -> RandAlgo:
    """Factory, like RandAlgoSelectorTk::stringToAlgo."""
    if name not in _RAND_ALGOS:
        raise ValueError(f"unknown random algorithm: {name!r} "
                         f"(choose from {', '.join(RAND_ALGO_NAMES)})")
    return _RAND_ALGOS[name](seed)
