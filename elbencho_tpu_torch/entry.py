"""Entry point of the flagship device step, the port's counterpart of
``__graft_entry__.entry()``: the ingest step (xor scramble + the
fingerprint kernel) and its arguments for one 1 MiB block.

    from elbencho_tpu_torch.entry import entry
    step, args = entry()          # on the current CUDA device
    scrambled, total, xor = step(*args)
"""

from __future__ import annotations


def entry(device=None):
    """(ingest_block_step, (block, bits)) on a 1 MiB block; ``device``
    None means the current CUDA device, and raises without one."""
    from .models.workloads import example_block, ingest_block_step
    block, bits = example_block(1 << 20, device)
    return ingest_block_step, (block, bits)
