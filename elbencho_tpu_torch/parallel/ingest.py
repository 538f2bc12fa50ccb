"""Sharded ingest step: the flagship step over every device of a mesh.

Reference: elbencho_tpu/parallel/ingest.py. A (rows, cols) uint32 batch
is laid out P("host", "chip") over the ("host", "chip") mesh: device
(h, c) holds the row block h and the column block c. Each device
scrambles and fingerprints its own shard with
``models.workloads.scramble_fingerprint_core`` (xor + the fingerprint
kernel), and the per-shard (sum, xor) fold over the mesh into the global
fingerprint. The JAX package psums the sums and all-gathers the xors over
the interconnect; here one process drives every device, so the fold is
on the host.

The JAX step draws each shard's bits inside, from
``fold_in(fold_in(key, h), c)``; the port takes them from the caller, as
its single-block step does (models/workloads.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.workloads import scramble_fingerprint_core


def shard_slices(mesh, rows: int, cols: int):
    """Per device in mesh order: the (row slice, column slice) of a
    (rows, cols) batch that it holds under P("host", "chip")."""
    hosts, chips = mesh.devices.shape
    if rows % hosts or cols % chips:
        raise ValueError(
            f"a ({rows}, {cols}) batch does not divide over the "
            f"{hosts}x{chips} mesh (rows by hosts, columns by chips)")
    r, c = rows // hosts, cols // chips
    return [(slice(h * r, (h + 1) * r), slice(k * c, (k + 1) * c))
            for h in range(hosts) for k in range(chips)]


def host_shard_to_devices(mesh, batch_np: np.ndarray) -> "list[torch.Tensor]":
    """Place a host uint32 batch onto the mesh with the ingest layout:
    one contiguous int32 shard per device, in mesh order (host->device
    copies across all devices)."""
    words = np.ascontiguousarray(batch_np, dtype=np.uint32).view(np.int32)
    return [torch.from_numpy(np.ascontiguousarray(words[rs, cs])).to(dev)
            for (rs, cs), dev in zip(shard_slices(mesh, *words.shape),
                                     mesh.devices.flat)]


def make_ingest_step(mesh):
    """The sharded ingest step over ``mesh``:

    step(shards, bits) -> (scrambled shards, checksum, xor)
      shards, bits: per-device int32 tensors in mesh order (as
        host_shard_to_devices places them), bits of each shard's shape
      checksum, xor: the global (sum mod 2^32, xor) as ints
    """
    n = int(mesh.devices.size)

    def step(shards, bits):
        if len(shards) != n or len(bits) != n:
            raise ValueError(f"the ingest step takes {n} shards and {n} "
                             f"bit blocks, got {len(shards)} and "
                             f"{len(bits)}")
        outs = [scramble_fingerprint_core(s, b) for s, b in zip(shards, bits)]
        total, xor = 0, 0
        for _scrambled, s, x in outs:
            total = (total + (int(s) & 0xFFFFFFFF)) & 0xFFFFFFFF
            xor ^= int(x) & 0xFFFFFFFF
        return [o[0] for o in outs], total, xor

    return step
