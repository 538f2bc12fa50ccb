"""TPUBENCH under --gpubench: host<->device copies without storage.

Reference: elbencho_tpu/workers/tpubench.py (``run_tpubench_phase``),
the netbench analogue over the device's host link, cut to its transfer
patterns (--gpubenchpat):

  h2d   host staging slot -> device memory   (cudaMemcpyAsync H2D)
  d2h   device memory -> host staging slot   (cudaMemcpy D2H)
  both  h2d followed by d2h per op, through the same slot
  ici / allgather / reducescatter / alltoall / psum
        one collective per step over the distinct devices of --gpuids
        (``CollectiveBench``), the NCCL perf-test analogue of the JAX
        package's XLA collectives

Each worker copies -s bytes in ops of up to -b bytes through the same
``CudaWorkerContext`` calls as the storage phases, so --gpudirect,
--gpubatch, --iodepth/--gpudepth and --gpubudget apply as they do there.
A staged d2h copies from the fill pool's host mirror, which was filled
from the device once (the pool path of ``device_to_host``), as the JAX
package's does: it measures a host memcpy, not the link.

The collective patterns (reference: ``CollectiveBench`` and
``_run_collective``, elbencho_tpu/workers/tpubench.py:83-223) are driven
by the first local worker alone, one process over every device of its
mesh. Each has one route on CUDA, fixed here and logged once per phase:
``ici`` (ring permute) and ``alltoall`` are peer copies
(``copy_(non_blocking=True)``) on every device type, the CPU's included;
``allgather``, ``reducescatter`` and ``psum`` are torch.cuda.nccl's
single-process calls, and on the CPU torch ops into output buffers of
the same shapes. Either way the step's result is folded from those
buffers by the same code. ``collective_plain``, torch ops over the list
of per-device tensors, is the version both are held against (the tests,
chip_smoke.py). A failed copy or NCCL call ends the phase; nothing falls
back.
"""

from __future__ import annotations

import time

import torch

from ..config.args import COLLECTIVE_PATTERNS
from ..toolkits.logger import LOG_NORMAL, log

MASK = 0xFFFFFFFF

#: the route of each collective pattern on CUDA
CUDA_ROUTES = {"ici": "peer copies", "alltoall": "peer copies",
               "allgather": "torch.cuda.nccl.all_gather",
               "reducescatter": "torch.cuda.nccl.reduce_scatter",
               "psum": "torch.cuda.nccl.all_reduce"}
#: the route of each reduction on the CPU (the copies are the same)
CPU_REDUCTION_ROUTE = "torch ops"


def run_gpubench_phase(worker) -> None:
    """Per op: take the next staging slot, copy, book the op's latency in
    the IOPS histogram and its bytes (twice under ``both``) in the live
    ops and the device accounting; the context's dispatch and copy times
    are synced per op, so an interrupt keeps the partial stats."""
    cfg = worker.cfg
    if cfg.gpu_bench_pattern in COLLECTIVE_PATTERNS:
        _run_collective(worker, cfg.gpu_bench_pattern)
        return
    ctx = worker._gpu
    to_device = cfg.gpu_bench_pattern in ("h2d", "both")
    to_host = cfg.gpu_bench_pattern in ("d2h", "both")
    bs = cfg.block_size
    total = max(cfg.file_size, bs)
    done = 0
    while done < total:
        worker.check_interruption_request()
        length = min(bs, total - done)
        buf = worker.rotated_staging_buf()
        t0 = time.perf_counter_ns()
        if to_device:
            ctx.host_to_device(buf, length)
        if to_host:
            ctx.device_to_host(buf, length)
        lat_usec = (time.perf_counter_ns() - t0) // 1000
        moved = length * (2 if to_device and to_host else 1)
        worker.iops_latency_histo.add_latency(lat_usec)
        worker.live_ops.num_bytes_done += moved
        worker.live_ops.num_iops_done += 1
        worker.gpu_transfer_bytes += moved
        worker._num_iops_submitted += 1
        done += length
        worker._sync_gpu_usec()
    ctx.flush()  # drain the in-flight ring; --gpubudget checks here
    worker._sync_gpu_usec()


def select_collective_devices(cfg) -> "list[torch.device]":
    """Devices of the collective (and --gpuslice) mesh. On CUDA the
    --gpuids subset of every device (ids modulo the device count,
    deduplicated; without --gpuids, every device). On the CPU, which a
    caller asks for with ``device="cpu"``, one slot per distinct --gpuids
    id, or without --gpuids as many as --meshshape covers (else one): the
    counterpart of the JAX package's virtual CPU devices, which a mesh
    without --tpuids spans whole."""
    ids = list(dict.fromkeys(cfg.gpu_ids))
    if cfg.device is not None and torch.device(cfg.device).type != "cuda":
        slots = len(ids)
        if not slots and cfg.mesh_shape_str:
            from ..parallel.slice_phase import parse_mesh_shape
            hosts, chips = parse_mesh_shape(cfg.mesh_shape_str)
            slots = hosts * chips
        return [torch.device(cfg.device)] * max(slots, 1)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the collective mesh needs CUDA devices, but "
            "torch.cuda.is_available() is false (the port does not fall "
            "back to the CPU)")
    all_devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    if not ids:
        return all_devices
    selected = list(dict.fromkeys(all_devices[i % len(all_devices)]
                                  for i in ids))
    if len(selected) != len(all_devices):
        log(LOG_NORMAL,
            f"NOTE: collective mesh restricted to {len(selected)} of "
            f"{len(all_devices)} chips (--gpuids)")
    return selected


def _sum_u32(t: torch.Tensor) -> int:
    """Wrapping uint32 sum of an int32 or int64 tensor's elements."""
    return int(t.to(torch.int64).sum()) & MASK


def collective_plain(pattern: str, arrays: "list[torch.Tensor]"):
    """The plain version of one step: torch ops over the per-device int32
    tensors. ``ici`` returns the permuted tensors (device i's block moves
    to device i+1); the others the replicated scalar of the JAX step,
    the uint32 sum over devices of each device's result summed, computed
    on the host from int64 copies of the tensors, whatever their
    devices."""
    n = len(arrays)
    if pattern == "ici":
        return [arrays[(i - 1) % n].to(arrays[i].device, copy=True)
                for i in range(n)]
    host = [a.to("cpu", torch.int64) for a in arrays]
    w = host[0].numel() // n
    if pattern == "allgather":
        per_dev = [sum(_sum_u32(a) for a in host) for _ in range(n)]
    elif pattern == "reducescatter":
        per_dev = [_sum_u32(sum(a[i * w:(i + 1) * w] for a in host))
                   for i in range(n)]
    elif pattern == "alltoall":
        per_dev = [sum(_sum_u32(a[i * w:(i + 1) * w]) for a in host)
                   for i in range(n)]
    elif pattern == "psum":
        per_dev = [_sum_u32(sum(host)) for _ in range(n)]
    else:
        raise ValueError(f"not a collective pattern: {pattern!r}")
    return sum(per_dev) & MASK


class CollectiveBench:
    """One collective per step over a 1-D mesh of devices, the
    worker-independent core of the collective patterns. Accounted bytes
    per step are the sharded array's total size (the NCCL perf-test
    "algorithm bytes" convention), as in the JAX package. ``arrays`` is
    the per-device input, one block of int32 words each (zeros; a caller
    may replace them)."""

    def __init__(self, pattern: str, devices: list, block_size: int):
        if pattern not in COLLECTIVE_PATTERNS:
            raise ValueError(f"not a collective pattern: {pattern!r}")
        self.pattern = pattern
        self.devices = [torch.device(d) for d in devices]
        n_dev = len(self.devices)
        bs_words = max(block_size // 4, 128)
        # all-to-all / reduce-scatter split the block across devices
        bs_words += (-bs_words) % n_dev
        self.block_size_adjusted = bs_words * 4
        self.bytes_per_step = n_dev * bs_words * 4
        self.arrays = [torch.zeros(bs_words, dtype=torch.int32, device=d)
                       for d in self.devices]
        self.on_cuda = self.devices[0].type == "cuda"
        self.route = CUDA_ROUTES[pattern] \
            if self.on_cuda or pattern in ("ici", "alltoall") \
            else CPU_REDUCTION_ROUTE
        self._outs: "list[torch.Tensor]" = []

    def compute(self):
        """One step's output, on this bench's route (see
        collective_plain for its form); completes before it returns."""
        arrays, n = self.arrays, len(self.arrays)
        w = arrays[0].numel() // n
        if not self._outs:
            shape = {"allgather": n * arrays[0].numel(),
                     "reducescatter": w}.get(self.pattern,
                                             arrays[0].numel())
            self._outs = [torch.empty(shape, dtype=torch.int32, device=d)
                          for d in self.devices]
        outs = self._outs
        if self.pattern == "ici":
            for i in range(n):
                outs[(i + 1) % n].copy_(arrays[i], non_blocking=True)
            for d in dict.fromkeys(self.devices):
                if d.type == "cuda":
                    torch.cuda.synchronize(d)
            return outs
        if self.pattern == "alltoall":
            for i in range(n):
                for j in range(n):
                    outs[i][j * w:(j + 1) * w].copy_(
                        arrays[j][i * w:(i + 1) * w], non_blocking=True)
        elif self.on_cuda:
            from torch.cuda import nccl
            if self.pattern == "allgather":
                nccl.all_gather(arrays, outs)
            elif self.pattern == "reducescatter":
                nccl.reduce_scatter(arrays, outs)
            else:
                nccl.all_reduce(arrays, outputs=outs)
        else:
            self._reduce_on_cpu(arrays, outs, w)
        return sum(_sum_u32(o) for o in outs) & MASK

    def _reduce_on_cpu(self, arrays, outs, w) -> None:
        """The reductions on CPU slots, written as NCCL writes them: the
        gathered blocks, or the int32 sums that wrap as NCCL's do."""
        if self.pattern == "allgather":
            for o in outs:
                torch.cat(arrays, out=o)
            return
        total = torch.stack(arrays).sum(0, dtype=torch.int64).to(
            torch.int32)
        for i, o in enumerate(outs):
            o.copy_(total[i * w:(i + 1) * w] if self.pattern ==
                    "reducescatter" else total)

    def warmup(self) -> None:
        """Allocate, build NCCL's communicator and run once outside any
        timed loop."""
        self.compute()

    def equals_plain(self) -> bool:
        """One step on the current ``arrays`` against collective_plain:
        the permuted tensors device by device for ici, else the scalar."""
        got = self.compute()
        want = collective_plain(self.pattern, self.arrays)
        if self.pattern == "ici":
            return all(g.device == w.device and torch.equal(g, w)
                       for g, w in zip(got, want))
        return got == want

    def step(self) -> int:
        """One timed collective; returns the latency in usec. The ring
        permute carries its output into the next step."""
        t0 = time.perf_counter_ns()
        out = self.compute()
        if self.pattern == "ici":
            self.arrays, self._outs = out, self.arrays
        return (time.perf_counter_ns() - t0) // 1000


def _run_collective(worker, pattern: str) -> None:
    """Drive CollectiveBench for the phase; only the first local worker
    drives the mesh (one process over every device). Per-step latency
    goes to the IOPS histogram; bytes into live ops and the device
    accounting."""
    cfg = worker.cfg
    if worker.rank % max(1, cfg.num_threads) != 0:
        worker.got_phase_work = False
        return
    devices = select_collective_devices(cfg)
    bench = CollectiveBench(pattern, devices, cfg.block_size)
    if bench.block_size_adjusted != cfg.block_size:
        log(LOG_NORMAL,
            f"NOTE: collective block size adjusted to "
            f"{bench.block_size_adjusted} bytes (word-aligned and "
            f"divisible by {len(devices)} chips); accounted bytes per "
            f"step use the adjusted size")
    log(LOG_NORMAL, f"collective {pattern} over {len(devices)} "
                    f"device(s): {bench.route}")
    total = max(cfg.file_size, cfg.block_size)
    bench.warmup()
    done = 0
    while done < total:
        worker.check_interruption_request(force=True)
        lat_usec = bench.step()
        worker.iops_latency_histo.add_latency(lat_usec)
        worker.live_ops.num_bytes_done += bench.bytes_per_step
        worker.live_ops.num_iops_done += 1
        worker.gpu_transfer_bytes += bench.bytes_per_step
        worker.gpu_transfer_usec += lat_usec
        done += bench.bytes_per_step
