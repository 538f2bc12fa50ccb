"""Parity of the port's device fill ops (elbencho_tpu_torch/ops/fill.py)
with the JAX package's jitted ones: the verify pattern must be
bit-identical (tolerance 0), since a file written by either package is
read back under the other's verify."""

import numpy as np
import pytest
import torch

from elbencho_tpu.ops import fill as jax_fill
from elbencho_tpu.tpu.device import _split_u64_params
from elbencho_tpu_torch.ops import fill as port_fill

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.mark.parametrize("offset,salt,num_words", [
    (0, 7, 16),
    (81920, 42, 1024),
    (0xFFFFFFFF - 40, 1, 33),            # lo crosses 2^32: carry into hi
    (0xFFFFFFF0, 0, 262144),             # carry at the first words
    ((1 << 64) - 16, 7, 9),              # base wraps 2^64, odd word count
    ((1 << 63) - 8, 3, 64),              # crosses the int64 sign bit
    (12345678 * 8, 99, 1),               # a single (padding) word
    (4096, 7, 1025),                     # odd count: zero padding word
])
def test_verify_pattern_matches_jax(offset, salt, num_words):
    want = np.asarray(jax_fill.verify_pattern_block_u32(
        _split_u64_params(offset, salt), num_words))
    got = port_fill.verify_pattern_block_u32(offset + salt, num_words, CPU)
    assert got.dtype == torch.int32 and got.shape == (num_words,)
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_random_block_is_seeded_by_the_generator():
    def draw(seed):
        gen = torch.Generator(device=CPU)
        gen.manual_seed(seed)
        return port_fill.random_block_u32(gen, 4096, CPU)

    a, b, c = draw(0), draw(0), draw(1)
    assert a.dtype == torch.int32 and a.shape == (4096,)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # the full 32-bit range is drawn: both signs of the int32 view occur
    assert (a < 0).any() and (a > 0).any()
