"""Flagship device-side workload: the device ingest pipeline step.

Reference: elbencho_tpu/models/workloads.py. The benchmark's "model" is
its device-side data pipeline; the flagship step does to a block resident
in device memory what the device data path does:

  1. scramble (xor with random bits; the block-variance analogue)
  2. fingerprint (sum + xor reduction; the on-device integrity verify)

The fingerprint is the port's hand-written CUDA kernel
(``ops.verify.fingerprint_u32``, ``csrc/fingerprint.cu``) on a GPU and
its plain PyTorch version on the CPU; the xor is a torch op. The JAX
package draws the bits inside the step from a PRNG key with threefry,
which the port does not reproduce: here the caller passes the bits, drawn
by ``example_block`` from an explicit ``torch.Generator``.

``elbencho_tpu_torch.entry.entry()`` exposes the step for a one-device
check; it is also the per-shard body of the later sharded step.
"""

from __future__ import annotations

import torch

from ..ops.fill import random_block_u32
from ..ops.verify import fingerprint_u32


def scramble_fingerprint_core(block: torch.Tensor, bits: torch.Tensor):
    """(block ^ bits, sum mod 2^32, xor) of int32 tensors holding uint32
    bit patterns; the two fingerprints are 0-d int32 tensors of uint32
    bits, on the block's device."""
    if block.shape != bits.shape or block.dtype != torch.int32 \
            or bits.dtype != torch.int32:
        raise ValueError(f"scramble_fingerprint_core takes two int32 "
                         f"tensors of one shape, got {block.dtype} "
                         f"{tuple(block.shape)} and {bits.dtype} "
                         f"{tuple(bits.shape)}")
    scrambled = torch.bitwise_xor(block, bits)
    total, xor = fingerprint_u32(scrambled.reshape(-1))
    return scrambled, total, xor


#: (block, bits) -> (scrambled block, sum fingerprint, xor fingerprint).
#: The JAX package keeps two names because its step draws the bits from a
#: PRNG key around the shared core; with the bits passed in, the two are
#: one function.
ingest_block_step = scramble_fingerprint_core


def example_block(num_bytes: int = 1 << 20, device=None,
                  generator: "torch.Generator | None" = None):
    """Example args for the flagship step: a zero block of ``num_bytes``
    (as int32 words) and random bits of its shape from ``generator``
    (default: a generator on the device seeded with 0). ``device`` None
    means the current CUDA device, and raises without one."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "example_block needs a CUDA device, but "
                "torch.cuda.is_available() is false (pass device='cpu' "
                "to run on the CPU)")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    n_words = num_bytes // 4
    block = torch.zeros(n_words, dtype=torch.int32, device=device)
    return block, random_block_u32(generator, n_words, device)
