"""Slice redistribution step: the multi-device core of the --gpuslice phase.

Reference: elbencho_tpu/parallel/slice_phase.py. The phase models what a
sharded-checkpoint restore does to a set of devices:

  1. every worker STRIPES the dataset off storage and feeds each device of
     the mesh its shard (storage -> staging slot -> device memory through
     the worker's TransferPipeline; workers/gpuslice.py drives that part);
  2. the mesh then RESHARDS the stripe to the --redistspec layout;
  3. the fingerprint kernel reduces each device's part of the
     redistributed stripe to (uint32 sum, xor), and the parts fold on the
     host, so the phase proves that the bytes survived ingest and
     redistribution exactly.

A stripe is an (n_devices, words_per_shard) uint32 array: row d lives on
mesh device ``mesh.devices.flat[d]``. The JAX package writes the
redistribution as a jitted identity whose output sharding differs from
its input's and lets XLA pick the collectives. Here it is explicit
copies into destination buffers that are allocated once per phase, one
CUDA stream per distinct device; what lands on each device equals the
shard JAX's output holds there:

  alltoall   P(None, ("host","chip")): device d holds every row's column
             slice d, (n, words/n): each device exchanges a slice with
             every other one. The default.
  host       P("host", None): device (h, c) holds the rows of host h,
             (chips, words).
  chip       P("chip", None): device (h, c) holds rows c*hosts ..
             (c+1)*hosts - 1, (hosts, words).
  replicate  P(None, None): every device holds the whole stripe, (n, words).

Each device fingerprints one part of what it holds, and the parts
partition the stripe (device d's whole buffer under alltoall; one row of
it under the others), so the folded fingerprint is the stripe's, whatever
the layout, with one kernel launch per device and stripe.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..ops.verify import fingerprint_u32

#: valid --redistspec names
REDIST_SPEC_NAMES = ("alltoall", "host", "chip", "replicate")


class MeshShapeError(ValueError):
    """Mesh geometry does not fit the device count / is malformed; the
    offending axis is named in the message. Converted to ConfigError at
    the config seam and to WorkerException at phase time."""


def parse_mesh_shape(spec: str) -> "tuple[int, int]":
    """"HxC" (hosts x chips, e.g. "2x4") -> (hosts, chips)."""
    parts = spec.lower().replace("*", "x").split("x")
    if len(parts) != 2:
        raise MeshShapeError(
            f"--meshshape must be HOSTSxCHIPS (e.g. 2x4), got {spec!r}")
    try:
        h, c = int(parts[0]), int(parts[1])
    except ValueError:
        raise MeshShapeError(
            f"--meshshape axes must be integers, got {spec!r}") from None
    if h < 1 or c < 1:
        raise MeshShapeError(
            f"--meshshape axes must be >= 1, got {spec!r}")
    return h, c


class SliceFingerprintError(RuntimeError):
    """Fingerprint of the redistributed stripe diverged from the host
    fingerprint of the ingested bytes — data corrupted on the ingest or
    redistribution path."""


def target_layout(name: str, hosts: int, chips: int, words: int):
    """Per destination device d = h*chips + c of a hosts x chips mesh:
    (source rows it holds, its column range, the local row it
    fingerprints, or None for its whole buffer)."""
    n = hosts * chips
    layout = []
    for d in range(n):
        h, c = divmod(d, chips)
        if name == "alltoall":
            cols = words // n
            layout.append((list(range(n)), (d * cols, (d + 1) * cols), None))
        elif name == "host":
            layout.append((list(range(h * chips, (h + 1) * chips)),
                           (0, words), c))
        elif name == "chip":
            layout.append((list(range(c * hosts, (c + 1) * hosts)),
                           (0, words), h))
        elif name == "replicate":
            layout.append((list(range(n)), (0, words), d))
        else:
            raise ValueError(f"unknown --redistspec {name!r} "
                             f"({'|'.join(REDIST_SPEC_NAMES)})")
    return layout


class SliceRunner:
    """Redistribute + fingerprint over one mesh, reused for every stripe
    of the phase; driven by the lead worker only. Destination buffers
    and per-device streams are made once, here."""

    def __init__(self, mesh, redist_spec: str, words_per_shard: int):
        self.n_devices = int(mesh.devices.size)
        self.words_per_shard = words_per_shard
        self.shard_bytes = words_per_shard * 4
        self.stripe_bytes = self.n_devices * self.shard_bytes
        if redist_spec == "alltoall" and words_per_shard % self.n_devices:
            raise ValueError(
                f"--redistspec alltoall cuts each shard into "
                f"{self.n_devices} slices: block size {self.shard_bytes} "
                f"must be a multiple of {4 * self.n_devices} bytes "
                f"(4-byte words x {self.n_devices} devices)")
        hosts, chips = mesh.devices.shape
        self.devices = list(mesh.devices.flat)
        self.local_device_indices = list(range(self.n_devices))
        self._layout = target_layout(redist_spec, hosts, chips,
                                     words_per_shard)
        # one stream per distinct CUDA device: the redistribution's copies
        # and the fingerprint launches run there, in order
        self._streams: "dict[torch.device, torch.cuda.Stream]" = {}
        for dev in self.devices:
            if dev.type == "cuda" and dev not in self._streams:
                self._streams[dev] = torch.cuda.Stream(dev)
        self.out: "list[torch.Tensor]" = []
        self._parts: "list[torch.Tensor]" = []
        for dev, (rows, (lo, hi), part_row) in zip(self.devices,
                                                   self._layout):
            buf = torch.empty((len(rows), hi - lo), dtype=torch.int32,
                              device=dev)
            self.out.append(buf)
            self._parts.append(buf.reshape(-1) if part_row is None
                               else buf[part_row])

    def _on_streams(self):
        """Every device stream current on its device at once: a copy
        between two devices orders itself against both current streams."""
        stack = contextlib.ExitStack()
        for stream in self._streams.values():
            stack.enter_context(torch.cuda.stream(stream))
        return stack

    def assemble(self, shard_arrays: "dict[int, tuple]") -> list:
        """Per-device shards (device index -> (1-D int32 tensor of
        words_per_shard on mesh.devices.flat[d], the event after its copy,
        or None)) -> the stripe, a list in device order. The shards may
        still have copies in flight: launch() orders itself after them."""
        if sorted(shard_arrays) != self.local_device_indices:
            raise ValueError(
                f"stripe assembly needs one shard per addressable "
                f"device: got {sorted(shard_arrays)}, expected "
                f"{self.local_device_indices}")
        return [shard_arrays[d] for d in self.local_device_indices]

    def launch(self, stripe: list) -> dict:
        """Enqueue the redistribution and return at once; complete()
        waits and accounts. On CUDA each device stream records the start
        event, waits for the copies of the shards on its device, runs the
        redistribution's copies and records the end event: IciRedistUSec
        is the device time from dispatch to the redistribution
        materialised, the window the JAX package's watcher thread stamps
        (a shard's copy still in flight counts in it, as there). On the
        CPU the copies run here, and their host time is the window."""
        t0 = time.perf_counter_ns()
        # the handle holds the stripe: its shards stay allocated until the
        # copies that read them are complete, whatever their feeder does
        handle = {"out": self.out, "stripe": stripe, "start": {}, "end": {},
                  "cpu_usec": 0}
        with self._on_streams():
            for dev, stream in self._streams.items():
                handle["start"][dev] = torch.cuda.Event(enable_timing=True)
                handle["start"][dev].record(stream)
            for (_shard, event), dev in zip(stripe, self.devices):
                if event is not None:
                    self._streams[dev].wait_event(event)
            for buf, (rows, (lo, hi), _part) in zip(self.out, self._layout):
                for k, r in enumerate(rows):
                    buf[k].copy_(stripe[r][0][lo:hi], non_blocking=True)
            for dev, stream in self._streams.items():
                handle["end"][dev] = torch.cuda.Event(enable_timing=True)
                handle["end"][dev].record(stream)
        t1 = time.perf_counter_ns()
        if not self._streams:
            handle["cpu_usec"] = (t1 - t0) // 1000
        handle["dispatch_usec"] = (t1 - t0) // 1000
        return handle

    def complete(self, handle: dict) -> "tuple[int, int, int]":
        """Wait for the redistribution, THEN fingerprint each device's
        part with the kernel (one launch per part) and fold the parts on
        the host; returns (sum, xor, usec from dispatch to the
        redistribution materialised). The fingerprint is a verify step,
        not interconnect traffic, so it stays out of the IciRedistUSec
        window."""
        usec = handle["cpu_usec"]
        for dev, end in handle["end"].items():
            end.synchronize()
            usec = max(usec, int(handle["start"][dev].elapsed_time(end)
                                 * 1000))
        usec = max(usec, 1)
        total, xor = 0, 0
        # the results are read on the streams that computed them: a
        # device's default stream does not wait for its other streams
        with self._on_streams():
            prints = [fingerprint_u32(part) for part in self._parts]
            for fp in prints:
                s, x = (v & 0xFFFFFFFF for v in fp.tolist())
                total = (total + s) & 0xFFFFFFFF
                xor ^= x
        return total, xor, usec

    def warmup(self) -> None:
        """Build the kernel and touch every buffer and stream outside any
        timed loop, with one stripe of zeros."""
        zeros = {d: (torch.zeros(self.words_per_shard, dtype=torch.int32,
                                 device=dev), None)
                 for d, dev in enumerate(self.devices)}
        self.complete(self.launch(self.assemble(zeros)))

    def verify(self, handle_sum: int, handle_xor: int,
               host_sum: int, host_xor: int, stripe_idx: int) -> None:
        """Fingerprint-exact check: the (sum, xor) of the redistributed
        stripe vs the host fingerprints of the bytes read off storage."""
        if handle_sum != host_sum or handle_xor != host_xor:
            raise SliceFingerprintError(
                f"stripe {stripe_idx}: redistributed fingerprint "
                f"(sum={handle_sum:#x}, xor={handle_xor:#x}) != host "
                f"fingerprint of the ingested bytes (sum={host_sum:#x}, "
                f"xor={host_xor:#x}) — data corrupted on the "
                f"ingest/redistribution path")


def host_fingerprint(block_u32: np.ndarray) -> "tuple[int, int]":
    """Order-independent (wrapping uint32 sum, xor) of a host block —
    the reference side of the fingerprint-exact verify."""
    total = int(block_u32.sum(dtype=np.uint64) & 0xFFFFFFFF)
    xor = int(np.bitwise_xor.reduce(block_u32.reshape(-1))) \
        if block_u32.size else 0
    return total, xor
