"""The flagship ingest step of the port (models/workloads.py, entry.py) on
the CPU against the JAX package's (elbencho_tpu/models/workloads.py,
__graft_entry__.py).

The JAX step draws its scramble bits inside from a PRNG key (threefry),
which the port does not reproduce; the port takes the bits as an
argument. So both sides get the same bits: the JAX package's own
``jax.random.bits`` for the key, handed to the port as a numpy array.
Scrambled block and (sum, xor) must agree exactly (tolerance 0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from elbencho_tpu.models import workloads as jax_workloads
from elbencho_tpu_torch import entry as port_entry
from elbencho_tpu_torch.models import workloads
from elbencho_tpu_torch.ops.verify import fingerprint_u32

torch.set_num_threads(1)

MASK = 0xFFFFFFFF


def as_torch(words_u32: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(words_u32.astype(np.uint32).view(np.int32))


def as_u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("n_words", [1, 127, 128, 4097, 262144])
def test_scramble_fingerprint_core_equals_the_jax_package(n_words):
    rng = np.random.default_rng(n_words)
    block = rng.integers(0, 1 << 32, n_words, dtype=np.uint64) \
        .astype(np.uint32)
    key = jax.random.PRNGKey(n_words)
    bits = np.asarray(jax.random.bits(key, block.shape, dtype=jnp.uint32))
    jax_out = jax_workloads.ingest_block_step(jnp.asarray(block), key)
    port_out = workloads.ingest_block_step(as_torch(block), as_torch(bits))
    np.testing.assert_array_equal(as_u32(port_out[0]),
                                  np.asarray(jax_out[0]))
    np.testing.assert_array_equal(as_u32(port_out[0]), block ^ bits)
    for port_fp, jax_fp in zip(port_out[1:], jax_out[1:]):
        assert port_fp.dim() == 0 and port_fp.dtype == torch.int32
        assert int(port_fp) & MASK == int(jax_fp)
    scrambled = block ^ bits
    assert int(port_out[1]) & MASK == int(scrambled.sum(dtype=np.uint64)
                                          & MASK)
    assert int(port_out[2]) & MASK == int(np.bitwise_xor.reduce(scrambled))


def test_core_refuses_mismatched_arguments():
    with pytest.raises(ValueError, match="two int32 tensors of one shape"):
        workloads.scramble_fingerprint_core(
            torch.zeros(4, dtype=torch.int32),
            torch.zeros(5, dtype=torch.int32))


def test_entry_matches_the_graft_entry():
    """entry(device="cpu") gives the same step signature and block shape
    as __graft_entry__.entry(), and the same outputs for the same bits."""
    jax_step, (jax_block, key) = __graft_entry__.entry()
    step, (block, bits) = port_entry.entry(device="cpu")
    assert block.shape == bits.shape == jax_block.shape == (262144,)
    assert block.dtype == bits.dtype == torch.int32
    assert block.element_size() == jax_block.dtype.itemsize
    assert not block.any()  # a zero block, as in the JAX package
    assert bits.any()
    jax_bits = np.asarray(jax.random.bits(key, jax_block.shape,
                                          dtype=jnp.uint32))
    jax_out = jax_step(jax_block, key)
    out = step(block, as_torch(jax_bits))
    assert [tuple(o.shape) for o in out] == \
        [tuple(np.shape(o)) for o in jax_out]
    np.testing.assert_array_equal(as_u32(out[0]), np.asarray(jax_out[0]))
    assert [int(o) & MASK for o in out[1:]] == [int(o) for o in jax_out[1:]]


def test_entry_bits_come_from_the_generator():
    """example_block draws full 32-bit words from an explicit generator:
    the same seed gives the same bits, another seed other bits."""
    def bits_for(seed):
        gen = torch.Generator()
        gen.manual_seed(seed)
        return workloads.example_block(4096, "cpu", gen)[1]
    assert torch.equal(bits_for(3), bits_for(3))
    assert not torch.equal(bits_for(3), bits_for(4))
    words = as_u32(workloads.example_block(1 << 20, "cpu")[1])
    assert words.max() >= 1 << 31 and words.min() < 1 << 31


def test_entry_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        port_entry.entry()


def test_step_launches_no_kernel_on_the_cpu():
    """On the CPU the fingerprint takes the plain version: no launch."""
    step, args = port_entry.entry(device="cpu")
    before = fingerprint_u32.launches.count
    step(*args)
    assert fingerprint_u32.launches.count == before
