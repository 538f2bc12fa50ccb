"""On-device block fill ops (write-source data generated in device memory).

Reference: elbencho_tpu/ops/fill.py, where these are jitted ``jnp`` ops
(not Pallas kernels) that replace upstream elbencho's cuRAND buffer fill:
blocks that will be written to storage originate in device memory and are
copied device->host into the I/O buffer. Here they are plain torch ops on
the given device.
"""

from __future__ import annotations

import torch


def verify_pattern_block_u32(base: int, num_words: int,
                             device: torch.device) -> torch.Tensor:
    """Integrity pattern as an int32 tensor of ``num_words`` words.

    The 64-bit word at byte offset ``off + 8*i`` equals ``off + 8*i +
    salt`` (LocalWorker::preWriteIntegrityCheckFillBuf), with ``base =
    (off + salt) mod 2^64``. The int64 sum wraps mod 2^64 and its
    little-endian int32 view is the lo/hi word pairs; an odd trailing word
    is zero."""
    base &= (1 << 64) - 1
    if base >= 1 << 63:
        base -= 1 << 64  # same bits as a signed int64
    n64 = num_words // 2
    vals = torch.arange(n64, dtype=torch.int64, device=device) * 8 + base
    out = vals.view(torch.int32)
    if num_words % 2:
        out = torch.cat([out, out.new_zeros(1)])
    return out


def random_block_u32(generator: torch.Generator, num_words: int,
                     device: torch.device) -> torch.Tensor:
    """Uniform random 32-bit words (int32 bits) from a device generator."""
    return torch.randint(-(1 << 31), 1 << 31, (num_words,),
                         dtype=torch.int32, generator=generator,
                         device=device)
