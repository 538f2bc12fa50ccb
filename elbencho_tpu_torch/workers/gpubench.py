"""TPUBENCH under --gpubench: host<->device copies without storage.

Reference: elbencho_tpu/workers/tpubench.py (``run_tpubench_phase``),
the netbench analogue over the device's host link, cut to its transfer
patterns (--gpubenchpat):

  h2d   host staging slot -> device memory   (cudaMemcpyAsync H2D)
  d2h   device memory -> host staging slot   (cudaMemcpy D2H)
  both  h2d followed by d2h per op, through the same slot

Each worker copies -s bytes in ops of up to -b bytes through the same
``CudaWorkerContext`` calls as the storage phases, so --gpudirect,
--gpubatch, --iodepth/--gpudepth and --gpubudget apply as they do there.
A staged d2h copies from the fill pool's host mirror, which was filled
from the device once (the pool path of ``device_to_host``), as the JAX
package's does: it measures a host memcpy, not the link. The collective
patterns (ici, allgather, reducescatter, alltoall, psum) need several
GPUs and are refused by the config check.
"""

from __future__ import annotations

import time


def run_gpubench_phase(worker) -> None:
    """Per op: take the next staging slot, copy, book the op's latency in
    the IOPS histogram and its bytes (twice under ``both``) in the live
    ops and the device accounting; the context's dispatch and copy times
    are synced per op, so an interrupt keeps the partial stats."""
    cfg = worker.cfg
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
