"""GPU device-memory data path: per-worker device buffers + host<->device transfers.

Reference: elbencho_tpu/tpu/device.py (``TpuWorkerContext``), rebuilt on
CUDA as ``CudaWorkerContext``; both replace upstream elbencho's CUDA
staging (LocalWorker.cpp:1427-1537, :2437-2490):

  cudaSetDevice / workerRank % gpuIDs  ->  worker rank % gpu_ids device pick
  cudaMalloc per iodepth               ->  one device buffer per ring slot,
                                           allocated once
  cudaMemcpyAsync H2D after reads      ->  ``copy_(non_blocking=True)`` on
                                           the context's own CUDA stream,
                                           completion tracked by events
  cudaMemcpy D2H before writes         ->  device fill pool / on-device
                                           verify pattern copied to a
                                           page-locked host buffer
  --cuhostbufreg                       ->  --gpudirect: cudaHostRegister'ed
                                           I/O slots copied to and from by
                                           DMA, no bounce buffer
  (JAX package's --tpubatch)           ->  --gpubatch: blocks staged into a
                                           page-locked aggregation buffer,
                                           one copy per batch

Every device call runs inside ``torch.cuda.stream(self.stream)``: the
current stream is per thread, and workers are threads. There are no
fallbacks: a failed registration or copy raises. On a CPU device (tests
only, by explicit request) the same code runs with plain copies and a
transfer completes at once.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque

import numpy as np
import torch

from ..ops.fill import random_block_u32, verify_pattern_block_u32
from ..ops.verify import load_kernel, verify_block_on_device
from ..toolkits.logger import LOG_NORMAL, log
from ..utils.staging_pool import StagingPool

#: H2D/D2H path-audit counter map: (context attribute, JSON key). The
#: keys keep the JAX package's names ("Tpu" there means "the device"), so
#: records of both packages compare key by key.
PATH_AUDIT_COUNTERS = (
    ("h2d_direct_ops", "TpuH2dDirectOps"),
    ("h2d_staged_ops", "TpuH2dStagedOps"),
    ("h2d_direct_fallbacks", "TpuH2dDirectFallbacks"),
    ("d2h_direct_ops", "TpuD2hDirectOps"),
    ("d2h_staged_ops", "TpuD2hStagedOps"),
    ("d2h_direct_fallbacks", "TpuD2hDirectFallbacks"),
    ("d2h_prefetch_hits", "TpuD2hPrefetchHits"),
    ("d2h_prefetch_misses", "TpuD2hPrefetchMisses"),
    ("pipe_full_stalls", "TpuPipeFullStalls"),
    ("pipe_inflight_hwm", "TpuPipeInflightHwm"),
    ("stream_fused_ops", "TpuStreamFusedOps"),
)

#: --gpuslice counters (workers/gpuslice.py), owned by the worker, not
#: by its device context: the slice phase runs with or without one
PATH_AUDIT_WORKER_COUNTERS = (
    ("shard_ingest_mib", "ShardIngestMiB"),
    ("ici_redist_mib", "IciRedistMiB"),
    ("ici_redist_usec", "IciRedistUSec"),
    ("ici_gbps_hwm", "IciGbpsHwm"),
)

#: counters that merge across workers as MAX, not sum: a high-water mark
#: summed over workers would report a depth (or a rate) no single ring
#: (or stripe) ever reached
PATH_AUDIT_MAX_KEYS = frozenset({"TpuPipeInflightHwm", "IciGbpsHwm"})


def sum_path_audit_counters(workers) -> dict:
    """Total the path-audit counters over the workers' device contexts
    and the worker-owned slice counters (keyed by JSON name);
    PATH_AUDIT_MAX_KEYS entries merge as max."""
    totals = {key: 0 for _, key in PATH_AUDIT_COUNTERS
              + PATH_AUDIT_WORKER_COUNTERS}
    for w in workers:
        ctx = getattr(w, "_gpu", None)
        pairs = [(w, attr, key) for attr, key in PATH_AUDIT_WORKER_COUNTERS]
        if ctx is not None:
            pairs += [(ctx, attr, key) for attr, key in PATH_AUDIT_COUNTERS]
        for owner, attr, key in pairs:
            val = getattr(owner, attr)
            if key in PATH_AUDIT_MAX_KEYS:
                totals[key] = max(totals[key], val)
            else:
                totals[key] += val
    return totals


class TransferPipeline:
    """Ring of up to ``depth`` in-flight device transfers with split
    dispatch-vs-DMA accounting: submit block k+1 while block k's copy is
    in flight, wait only when the ring is full or at flush. Entries are
    ``(torch.cuda.Event, submit_ns)``; on a CPU device the event is None
    and the entry is complete at once.

    Counters (all per-phase, reset via reset_counters):

    - ``dispatch_usec``  host-side submit cost of issuing transfers.
    - ``transfer_usec``  submission -> completion per transfer, measured
      when the ring entry is drained (windows overlap: per-block latency,
      not a divisor for bandwidth).
    - ``full_stalls``    full-ring drains that had to WAIT for the oldest
      transfer (zero on a fully overlapped pipeline).
    - ``inflight_hwm``   in-flight high-water mark (>= 2 proves overlap).

    ``budget_usec`` (--gpubudget): maximum average host-side dispatch
    cost per op; check_budget() fails the run when it is exceeded.
    """

    def __init__(self, depth: int, budget_usec: int = 0, stream=None):
        self.depth = max(depth, 1)
        self.budget_usec = max(budget_usec, 0)
        self.stream = stream
        self._ring = deque()
        self.dispatch_usec = 0
        self.transfer_usec = 0
        self.full_stalls = 0
        self.inflight_hwm = 0
        self.ops = 0

    def submit(self, submit_fn, stream=None):
        """Start one transfer (submit_fn enqueues it on the stream: the
        pipeline's, or ``stream``) into the ring, then drain to at most
        depth-1 in flight: with depth rotating buffers, the buffer reused
        next is then drained. Returns the transfer's completion event
        (None on the CPU)."""
        stream = stream if stream is not None else self.stream
        t0 = time.perf_counter_ns()
        submit_fn()
        event = None
        if stream is not None:
            event = torch.cuda.Event()
            event.record(stream)
        t1 = time.perf_counter_ns()
        self.dispatch_usec += (t1 - t0) // 1000
        self.ops += 1
        self._ring.append((event, t1))
        if len(self._ring) > self.inflight_hwm:
            self.inflight_hwm = len(self._ring)
        while len(self._ring) >= self.depth:
            self._drain_one(count_stall=True)
        return event

    def note_dispatch(self, usec: int) -> None:
        """Account host-side submit cost of a transfer issued outside the
        ring (D2H), so --gpubudget covers both directions."""
        self.dispatch_usec += usec
        self.ops += 1

    def note_transfer(self, usec: int) -> None:
        """Account the wait of a transfer completed outside the ring."""
        self.transfer_usec += usec

    def _drain_one(self, count_stall: bool = False) -> None:
        """Complete the oldest in-flight transfer; a full-ring drain only
        counts as a stall when the copy had not finished yet."""
        event, t_submit = self._ring.popleft()
        if event is not None:
            if count_stall and not event.query():
                self.full_stalls += 1
            event.synchronize()
        self.transfer_usec += (time.perf_counter_ns() - t_submit) // 1000

    def flush(self, check_budget: bool = True) -> None:
        """Drain every in-flight transfer; by default also enforce
        --gpubudget (teardown passes check_budget=False)."""
        while self._ring:
            self._drain_one()
        if check_budget:
            self.check_budget()

    def drain_to(self, max_inflight: int) -> None:
        """Drain the ring until at most max_inflight transfers are in
        flight: a caller about to rewrite a host buffer submitted k
        transfers ago drains to k-1 first, and the copy from it has
        then completed."""
        while len(self._ring) > max(max_inflight, 0):
            self._drain_one()

    def check_budget(self) -> None:
        if not self.budget_usec or not self.ops:
            return
        avg = self.dispatch_usec / self.ops
        if avg > self.budget_usec:
            raise RuntimeError(
                f"--gpubudget exceeded: measured per-op dispatch overhead "
                f"{avg:.1f} usec > budget {self.budget_usec} usec over "
                f"{self.ops} ops ({self.dispatch_usec} usec host-side "
                f"dispatch total; DMA wall {self.transfer_usec} usec)")

    def reset_counters(self) -> None:
        self.dispatch_usec = 0
        self.transfer_usec = 0
        self.full_stalls = 0
        self.inflight_hwm = 0
        self.ops = 0


def resolve_device(chip_id: int, device: "str | None") -> torch.device:
    """cuda:<chip_id> unless the caller asked for another device. There is
    no silent CPU fallback: without CUDA this raises."""
    if device is not None:
        dev = torch.device(device)
        if dev.type != "cuda":
            return dev
        chip_id = dev.index if dev.index is not None else chip_id
    if not torch.cuda.is_available():
        raise RuntimeError(
            "--gpuids needs a CUDA device, but torch.cuda.is_available() "
            "is false (the port does not fall back to the CPU)")
    if chip_id >= torch.cuda.device_count():
        raise RuntimeError(f"GPU {chip_id} does not exist (this machine "
                           f"has {torch.cuda.device_count()} CUDA devices)")
    return torch.device("cuda", chip_id)


def hbm_bytes_limit(device: torch.device, pct: int) -> int:
    """--gpuhbmpct: usable device-memory staging budget."""
    if device.type == "cuda":
        _free, total = torch.cuda.mem_get_info(device)
        return total * pct // 100
    return 1 << 30  # the JAX package's default for a device without stats


class CudaWorkerContext:
    """Per-worker handle to one GPU's memory (CuFileHandleData analogue,
    reference source/CuFileHandleData.h:18-73)."""

    #: device-resident pre-filled source blocks (curand-at-alloc parity)
    _FILL_POOL_BLOCKS = 4

    #: consecutive speculation misses before the verify-pattern prefetch
    #: concludes the offset stream is not sequential and stops
    _D2H_SPEC_MISS_LIMIT = 8

    def __init__(self, chip_id: int, block_size: int, direct: bool = False,
                 verify_on_device: bool = False, pipeline_depth: int = 1,
                 hbm_limit_pct: int = 90, dispatch_budget_usec: int = 0,
                 batch_blocks: int = 1,
                 staging_pool: "StagingPool | None" = None,
                 device: "str | None" = None):
        self.chip_id = chip_id
        self.device = resolve_device(chip_id, device)
        self.on_cuda = self.device.type == "cuda"
        self.direct = direct
        self.verify_on_device = verify_on_device
        # --gpuhbmpct budget: resident device memory is the fill pool +
        # the in-flight ring + the last-ingested block. The pool shrinks
        # and the depth is clamped to fit; below the 3-block floor (1
        # pool/in-flight + 1 sink + 1 headroom) the block size is refused.
        budget_bytes = hbm_bytes_limit(self.device, hbm_limit_pct)
        budget_blocks = budget_bytes // max(block_size, 1)
        if budget_blocks < 3:
            raise RuntimeError(
                f"block size {block_size} exceeds the device memory staging "
                f"budget of GPU {chip_id} ({budget_bytes} bytes at "
                f"--gpuhbmpct {hbm_limit_pct} fits fewer than 3 blocks)")
        # --gpubatch: coalesce N blocks into one copy, paying the
        # per-transfer dispatch cost once per batch. Disabled under
        # on-device verify, which needs per-block device blocks.
        self.batch_blocks = max(batch_blocks, 1)
        if verify_on_device and self.batch_blocks > 1:
            log(LOG_NORMAL, "NOTE: --gpubatch is ignored with "
                            "--gpuverify (per-block on-device checks)")
            self.batch_blocks = 1
        self._pool_blocks = min(self._FILL_POOL_BLOCKS,
                                max(budget_blocks - 2, 1))
        # one aggregated span must itself fit the budget beside the sink
        # block: clamp the batch BEFORE the depth, which it divides
        spare_blocks = max(budget_blocks - self._pool_blocks - 1, 2)
        if self.batch_blocks > spare_blocks // 2:
            clamped = max(spare_blocks // 2, 1)
            log(LOG_NORMAL,
                f"NOTE: --gpubatch {self.batch_blocks} exceeds the HBM "
                f"staging budget; clamped to {clamped}")
            self.batch_blocks = clamped
        # the H2D ring and the D2H speculation ring each get depth slots,
        # and with batching each H2D slot holds batch_blocks blocks
        max_depth = max((budget_blocks - self._pool_blocks - 1)
                        // (2 * self.batch_blocks), 1)
        self.pipeline_depth = min(max(pipeline_depth, 1), max_depth)
        self.stream = torch.cuda.Stream(self.device) if self.on_cuda \
            else None
        self._own_pool = None
        if staging_pool is None:
            staging_pool = self._own_pool = StagingPool(0, 0)
        self._pool = staging_pool
        if direct and self.on_cuda:
            # one-time page-lock of the I/O slots (--cuhostbufreg)
            staging_pool.register_slots()
        self._num_words = max(block_size // 4, 1)
        # one H2D ring slot on the device: a block, or a --gpubatch span
        # rounded up to whole words (e.g. -b 6 --gpubatch 3)
        self._slot_bytes = self._num_words * 4
        if self.batch_blocks > 1:
            agg_bytes = self.batch_blocks * max(block_size, 1)
            self._slot_bytes = max(agg_bytes + (-agg_bytes) % 4, 4)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(chip_id)
        self._pipeline = TransferPipeline(self.pipeline_depth,
                                          budget_usec=dispatch_budget_usec,
                                          stream=self.stream)
        # H2D ring slots: one device block per slot (+ a page-locked
        # bounce buffer per slot on the staged path), allocated once.
        # With --gpubatch the page-locked host buffer of a slot is its
        # aggregation buffer instead, the copy's source on both paths;
        # one per slot, so a buffer is not refilled while its copy is in
        # flight (the ring drains it before the rotation comes back).
        self._dev_slots: "list[torch.Tensor]" = []
        self._bounce: "list[torch.Tensor]" = []
        self._profile_warmup: "tuple[torch.Tensor, torch.Tensor] | None" \
            = None
        self._h2d_agg_bytes = 0  # bytes staged in the active agg buffer
        self._h2d_submits = 0
        self._last_ingested = None
        # write-source pool: filled ONCE, like the reference's
        # curandGenerate at allocGPUIOBuffer time; (device block, host
        # mirror) pairs, the mirror None under --gpudirect
        self._fill_pool: list = []
        self._fill_idx = 0
        # speculative verify-pattern ring: (offset, length, salt) ->
        # (device block, host copy, event); host copies go to depth+1
        # page-locked buffers, each new copy to one that no live entry holds
        # (at most depth speculated + the one being consumed are live)
        self._d2h_spec: dict = {}
        self._d2h_spec_miss_streak = 0
        self._spec_bufs: "list[torch.Tensor]" = []
        self.h2d_direct_ops = 0
        self.h2d_staged_ops = 0
        self.d2h_direct_ops = 0
        self.d2h_staged_ops = 0
        self.d2h_prefetch_hits = 0
        self.d2h_prefetch_misses = 0
        # schema entries of the JAX package's fallback latches: the port
        # has no fallback, so these stay 0
        self.h2d_direct_fallbacks = 0
        self.d2h_direct_fallbacks = 0
        self.stream_fused_ops = 0  # storage ops of the fused stream ring
        if verify_on_device and self.on_cuda:
            load_kernel()  # build outside the timed phase

    def _on_stream(self):
        return torch.cuda.stream(self.stream) if self.stream is not None \
            else contextlib.nullcontext()

    def _host_buffers(self, count: int,
                      nbytes: int = 0) -> "list[torch.Tensor]":
        """`count` host buffers of `nbytes` (default: one block) from the
        staging pool, page-locked when the device is a GPU."""
        return [torch.frombuffer(mv, dtype=torch.uint8)
                for mv in self._pool.alloc_aux(
                    count, nbytes or self._num_words * 4,
                    register=self.on_cuda)]

    # -- read path: host buffer -> device ----------------------------------

    def host_to_device(self, buf: memoryview, length: int,
                       verify_salt: int = 0, file_offset: int = 0) -> None:
        """Copy the freshly read block into device memory (replaces
        cudaMemcpyAsync H2D, LocalWorker.cpp:2437-2490). Up to
        pipeline_depth copies overlap; the call waits only when the ring
        is full. With --gpuverify the fingerprint kernel checks the block
        on the device instead of the host-side memcmp.

        - staged (default): the slot is copied into the ring slot's
          page-locked bounce buffer, which is copied asynchronously to
          the device; the I/O slot is free again at once.
        - direct (--gpudirect): the registered I/O slot itself is the
          copy's source, so it must not be rewritten before the copy
          completes — the ring depth is clamped to --iodepth for that.
        - batched (--gpubatch): the block's words are staged into the
          active aggregation buffer, and one copy of that buffer goes
          out when the next block would not fit (or at flush); it counts
          as one op of the path (staged or direct) that was asked for.
        """
        nbytes = (length // 4) * 4
        self._ensure_h2d_slots()
        if self.batch_blocks > 1:
            agg = self._bounce[self._active_h2d_slot()].numpy()
            start = self._h2d_agg_bytes
            self._h2d_agg_bytes = start + nbytes
            agg[start:self._h2d_agg_bytes] = np.frombuffer(
                buf, dtype=np.uint8, count=nbytes)
            if self._h2d_agg_bytes + self._num_words * 4 > len(agg):
                self._flush_h2d_batch()
            return
        src = torch.frombuffer(buf, dtype=torch.uint8, count=nbytes) \
            if nbytes else torch.empty(0, dtype=torch.uint8)
        dst = self._transfer_h2d(src, nbytes, pinned=self.direct)
        if verify_salt and self.verify_on_device:
            with self._on_stream():
                verify_block_on_device(dst.view(torch.int32), file_offset,
                                       length, verify_salt)

    def _transfer_h2d(self, src: torch.Tensor, nbytes: int,
                      pinned: bool) -> torch.Tensor:
        """One copy of `nbytes` into the next device ring slot through the
        in-flight pipeline; returns the slot's device view. A `pinned`
        source (a registered I/O slot, or an aggregation buffer) is
        copied from as it is; any other goes through the slot's
        page-locked bounce buffer first."""
        slot = self._active_h2d_slot()
        self._h2d_submits += 1
        dst = self._dev_slots[slot][:nbytes]
        if pinned:
            def submit():
                with self._on_stream():
                    dst.copy_(src, non_blocking=True)
                if self.direct:
                    self.h2d_direct_ops += 1
                else:
                    self.h2d_staged_ops += 1
        else:
            bounce = self._bounce[slot][:nbytes]

            def submit():
                # host memcpy through numpy: single-threaded, where torch's
                # CPU copy would start its intra-op thread pool per block
                np.copyto(bounce.numpy(), src.numpy())
                with self._on_stream():
                    dst.copy_(bounce, non_blocking=True)
                self.h2d_staged_ops += 1
        self._pipeline.submit(submit)
        self._last_ingested = dst  # keep resident (benchmark sink)
        return dst

    def _active_h2d_slot(self) -> int:
        """The ring slot the next H2D copy goes to; under --gpubatch its
        host buffer is also the one blocks are staged into."""
        return self._h2d_submits % self.pipeline_depth

    def _flush_h2d_batch(self) -> None:
        """Copy the active aggregation buffer's staged bytes to the
        device; the next batch stages into the next slot's buffer."""
        if not self._h2d_agg_bytes:
            return
        nbytes = self._h2d_agg_bytes
        self._h2d_agg_bytes = 0
        self._transfer_h2d(self._bounce[self._active_h2d_slot()][:nbytes],
                           nbytes, pinned=True)

    def _ensure_h2d_slots(self) -> None:
        if not self._dev_slots:
            self._dev_slots = [
                torch.empty(self._slot_bytes, dtype=torch.uint8,
                            device=self.device)
                for _ in range(self.pipeline_depth)]
            if self.batch_blocks > 1:
                self._bounce = self._host_buffers(self.pipeline_depth,
                                                  self._slot_bytes)
            elif not self.direct:
                self._bounce = self._host_buffers(self.pipeline_depth)

    def holdback_depth(self) -> int:
        """How many freshly ingested I/O slots the fused stream loop must
        keep out of the engine's ring after their host_to_device: an
        unbatched --gpudirect copy reads the slot itself until it
        completes, and the ring holds at most depth-1 copies after every
        submit, so holding the last depth-1 ingested slots is exactly
        the guarantee that no slot is read into while its copy runs. The
        staged and --gpubatch paths copy the block out at submit and
        need no holdback."""
        if self.direct and self.batch_blocks == 1:
            return self.pipeline_depth - 1
        return 0

    def drain_to(self, max_inflight: int) -> None:
        """Drain the transfer ring to at most max_inflight copies: the
        fused stream loop releases a held-back slot with it, without
        waiting for more storage completions."""
        self._pipeline.drain_to(max_inflight)

    @property
    def _inflight(self):
        """Read access to the ring for tests and diagnostics."""
        return self._pipeline._ring

    @property
    def pipe_full_stalls(self) -> int:
        return self._pipeline.full_stalls

    @property
    def pipe_inflight_hwm(self) -> int:
        return self._pipeline.inflight_hwm

    @property
    def dispatch_usec(self) -> int:
        """Host-side submit cost this phase (both directions)."""
        return self._pipeline.dispatch_usec

    @property
    def transfer_usec(self) -> int:
        """Transfer wall time this phase (both directions)."""
        return self._pipeline.transfer_usec

    def reset_path_counters(self) -> None:
        """Zero the path-audit counters (per phase, like the worker's
        byte counters) and drain the ring. Speculation resets with them:
        a random phase must not leave prefetch disabled for a later
        sequential one."""
        for attr, _key in PATH_AUDIT_COUNTERS:
            if not attr.startswith("pipe_"):
                setattr(self, attr, 0)
        self._pipeline.flush(check_budget=False)
        self._pipeline.reset_counters()
        self._d2h_spec.clear()
        self._d2h_spec_miss_streak = 0
        # a phase that ended without reaching flush() (worker error or
        # interrupt) must not leak its staged batch into the next phase
        self._h2d_agg_bytes = 0

    def flush(self) -> None:
        """Drain all pipelined transfers (phase-end completion wait),
        including a partly filled --gpubatch span, then enforce
        --gpubudget."""
        self._flush_h2d_batch()
        self._pipeline.flush()

    def profile_warmup(self) -> None:
        """One 4-byte host->device copy on this worker's stream, made at
        the start of each phase that --gpuprofile traces, outside the
        path-audit counters. In a process that had run chip_smoke.py's
        kernel phase first, torch.profiler left one copy record out of
        every traced read, and none once each worker thread had made this
        copy (chip_profile_records.py). The first call, from worker
        prepare, allocates the two buffers (``empty``: no fill kernel)."""
        if self.stream is None:
            return
        if self._profile_warmup is None:
            self._profile_warmup = (
                torch.empty(1, dtype=torch.int32, device=self.device),
                torch.zeros(1, dtype=torch.int32).pin_memory())
        dst, src = self._profile_warmup
        with self._on_stream():
            dst.copy_(src, non_blocking=True)
        self.stream.synchronize()

    def warmup_transfer(self) -> None:
        """Allocate the H2D ring's device slots and bounce buffers outside
        any timed loop (called from worker prepare for read workloads)."""
        self._ensure_h2d_slots()

    def _ensure_fill_pool(self) -> None:
        if self._fill_pool:
            return
        mirrors = [None] * self._pool_blocks if self.direct \
            else self._host_buffers(self._pool_blocks)
        with self._on_stream():
            for host in mirrors:
                block = random_block_u32(self._generator, self._num_words,
                                         self.device)
                if host is not None:
                    host.copy_(block.view(torch.uint8), non_blocking=True)
                self._fill_pool.append((block, host))
        if self.stream is not None:
            self.stream.synchronize()  # the mirrors are filled once

    def warmup_fill(self) -> None:
        """Build the device fill pool ahead of the first measured phase
        (called from worker prepare for plain write workloads)."""
        self._ensure_fill_pool()

    # -- write path: device -> host buffer ----------------------------------

    def device_to_host(self, buf: memoryview, length: int,
                       verify_salt: int = 0, file_offset: int = 0) -> None:
        """The write-source block originates in device memory (the fill
        pool, or the on-device verify pattern under --verify) and is
        copied into the host I/O buffer (replaces curandGenerate +
        cudaMemcpy D2H, LocalWorker.cpp:1427-1537).

        - pool path (plain writes): staged, the pool's host mirrors were
          filled once, so a call only copies mirror -> I/O slot; direct,
          the device block is copied by DMA into the registered slot.
        - verify path (--verify): the block depends on file_offset, so the
          ring speculates — after serving offset o it computes the
          patterns for o+len .. o+depth*len on the device and (staged)
          starts their copies into page-locked buffers; a sequential
          stream hits (d2h_prefetch_hits), a random one misses
          (d2h_prefetch_misses) and speculation stops after a miss streak.
        """
        n_words = max(length // 4, 1)
        t0 = time.perf_counter_ns()
        if verify_salt:
            block, host, event = self._verify_block_pipelined(
                length, n_words, verify_salt, file_offset)
        else:
            self._ensure_fill_pool()
            self._fill_idx = (self._fill_idx + 1) % len(self._fill_pool)
            block, host = self._fill_pool[self._fill_idx]
            event = None
        t1 = time.perf_counter_ns()
        self._pipeline.note_dispatch((t1 - t0) // 1000)
        dst = torch.frombuffer(buf, dtype=torch.uint8, count=length)
        n = min(n_words * 4, length)
        if self.direct:
            with self._on_stream():
                dst[:n].copy_(block.view(torch.uint8)[:n], non_blocking=True)
            if self.stream is not None:
                self.stream.synchronize()
            self.d2h_direct_ops += 1
        else:
            if event is not None:
                event.synchronize()
            np.copyto(dst[:n].numpy(), host[:n].numpy())
            self.d2h_staged_ops += 1
        self._pipeline.note_transfer((time.perf_counter_ns() - t1) // 1000)
        if length % 4:  # trailing sub-word bytes the word view can't carry
            dst[n_words * 4:] = 0
        if verify_salt and length % 8:
            dst[(length // 8) * 8:] = 0

    def _verify_block_pipelined(self, length: int, n_words: int,
                                verify_salt: int, file_offset: int):
        """Serve the verify-pattern block for file_offset, preferably from
        the speculative ring, and re-arm speculation for the sequential
        continuation of the stream."""
        entry = self._d2h_spec.pop((file_offset, length, verify_salt), None)
        if entry is not None:
            self.d2h_prefetch_hits += 1
            self._d2h_spec_miss_streak = 0
        else:
            if self._d2h_spec:
                # mispredicted stream: the speculated blocks are stale
                self.d2h_prefetch_misses += 1
                self._d2h_spec_miss_streak += 1
                self._d2h_spec.clear()
            entry = self._issue_pattern(file_offset, verify_salt, n_words)
        # evaluated AFTER miss accounting so the ring cannot re-arm on the
        # very call whose miss reached the limit
        if self._d2h_spec_miss_streak < self._D2H_SPEC_MISS_LIMIT:
            for k in range(1, self.pipeline_depth + 1):
                if len(self._d2h_spec) >= self.pipeline_depth:
                    break
                nxt = (file_offset + k * length, length, verify_salt)
                if nxt not in self._d2h_spec:
                    self._d2h_spec[nxt] = self._issue_pattern(
                        nxt[0], verify_salt, n_words, serving=entry)
        return entry

    def _issue_pattern(self, file_offset: int, salt: int, n_words: int,
                       serving=None):
        """(device block, host copy or None, event or None) of the verify
        pattern at file_offset; on the staged path its copy into a free
        page-locked buffer is already started. A buffer is free when
        neither a speculated entry nor `serving`, the entry the current
        call is about to copy out, holds it: a stream that skips a
        speculated offset keeps that entry live, so a plain rotation
        over the buffers would overwrite it."""
        with self._on_stream():
            block = verify_pattern_block_u32(file_offset + salt, n_words,
                                             self.device)
            if self.direct:
                return block, None, None
            if not self._spec_bufs:
                self._spec_bufs = self._host_buffers(self.pipeline_depth + 1)
            held = [e[1] for e in self._d2h_spec.values()]
            if serving is not None:
                held.append(serving[1])
            held_ptrs = {h.data_ptr() for h in held}
            host = next(b for b in self._spec_bufs
                        if b.data_ptr() not in held_ptrs)[:n_words * 4]
            host.copy_(block.view(torch.uint8), non_blocking=True)
            event = None
            if self.stream is not None:
                event = torch.cuda.Event()
                event.record(self.stream)
        return block, host, event

    def close(self) -> None:
        # teardown drain: no --gpubudget check here — a breach surfaces at
        # the phase-end flush(), never as a secondary error mid-cleanup
        self._flush_h2d_batch()
        self._pipeline.flush(check_budget=False)
        if self.stream is not None:
            self.stream.synchronize()  # speculative copies still in flight
        self._last_ingested = None
        self._dev_slots = []
        self._bounce = []
        self._fill_pool = []
        self._d2h_spec = {}
        self._spec_bufs = []
        if self._own_pool is not None:
            self._own_pool.close()
            self._own_pool = None
