"""Parity of the port's toolkit copies with the JAX package's: sizes parse
the same, the "fast" PRNG draws the same sequence, and the offset
generators yield the same blocks (so both packages lay out the same file
under the same seed)."""

import pytest

from elbencho_tpu.toolkits import offset_gen as jax_gen
from elbencho_tpu.toolkits.random_algos import create_rand_algo
from elbencho_tpu.toolkits.units import parse_size as jax_parse_size
from elbencho_tpu_torch.toolkits import offset_gen as port_gen
from elbencho_tpu_torch.toolkits.random_algos import RandAlgoGoldenPrime
from elbencho_tpu_torch.toolkits.units import parse_size


@pytest.mark.parametrize("text", ["4K", "1M", "16M", "10g", "1GiB", "2TB",
                                  "1.5G", "0", "123", "4kb", "7b", ""])
def test_parse_size_matches_jax(text):
    assert parse_size(text) == jax_parse_size(text)


def test_fast_prng_sequence_matches_jax():
    jax_rand, port_rand = create_rand_algo("fast", seed=3), \
        RandAlgoGoldenPrime(seed=3)
    # past a 256 KiB reseed boundary, scalar and batched
    assert [jax_rand.next64() for _ in range(40000)] == \
        [port_rand.next64() for _ in range(40000)]
    assert jax_rand.fill_buffer(1 << 20) == port_rand.fill_buffer(1 << 20)


@pytest.mark.parametrize("num_bytes,block,range_len", [
    (10 << 20, 1 << 20, 16 << 20),
    (3000, 512, 8192),
    (8 << 20, 1 << 20, 8 << 20),
])
@pytest.mark.parametrize("name", ["OffsetGenRandomAligned",
                                  "OffsetGenRandomAlignedFullCoverage"])
def test_random_offset_generators_match_jax(name, num_bytes, block,
                                            range_len):
    want = list(getattr(jax_gen, name)(create_rand_algo("fast", seed=5),
                                       num_bytes, block, range_len=range_len))
    got = list(getattr(port_gen, name)(RandAlgoGoldenPrime(seed=5),
                                       num_bytes, block, range_len=range_len))
    assert got == want


def test_sequential_offsets_match_jax():
    assert list(port_gen.OffsetGenSequential(1000, 300, start=7)) == \
        list(jax_gen.OffsetGenSequential(1000, 300, start=7))
