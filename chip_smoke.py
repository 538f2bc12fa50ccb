#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (elbencho_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

It needs one CUDA device and the repository beside it, and exits nonzero
without printing a result otherwise. In order it:

1. prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and the build times of the kernel and of the native I/O
   engine (csrc/ioengine.cpp, g++);
2. builds the fingerprint kernel (csrc/fingerprint.cu) with nvcc and holds
   it against its plain PyTorch version on the card, exactly (tolerance 0:
   addition mod 2^32 and xor do not depend on order), at several word
   counts up to 64 Mi words and at word counts that straddle the edges of
   the kernel's chunk plan at every 4-byte offset; checks that a flipped
   bit is caught, that two threads on two streams get right results at
   the same time, and (where torch.profiler traces the card) that a call
   enqueues the kernel and nothing else; prints the compiler's register,
   shared-memory and spill report; times the kernel, its plain version and
   torch.sum (the sum half only: no PyTorch call computes the xor
   reduction) at 4 KiB (the small-files pass's block) and at 1 to 256 MiB,
   the main path's 16 MiB block among them;
3. drives the port's main path through its CLI on a 4 GiB file
   (-s 10g of the README's headline command, cut to fit the smoke's time),
   through the fused --gpustream ring (--gpustream on): write+read with
   --verify and --gpuverify, a --gpudirect read, and a plain write+read
   through the device fill pool; then the two --gpuverify passes again
   through the Python loop (--gpustream off); asserts bytes, ops, which
   loop served every op, that the kernel ran once per block read under
   --gpuverify, and that --gpudirect copied from page-locked slots;
   then bench.py's headline shape, a plain -r -t 2 -b 16M --iodepth 4
   read of the file, staged and --gpudirect, through the fused ring and
   through the Python loop (--gpustream off), three runs each in
   alternating order, printing each one's median rates, dispatch cost,
   in-flight high-water mark and full stalls, and the ring's backend,
   which must be the one the engine probes (io_uring where the kernel
   has it, with its fixed-buffer registration printed);
4. reads the same file with -b 1M, without and with --gpubatch 16, staged
   and --gpudirect, through the ring and (--gpubatch 16) the Python
   loop, and checks that the batch cuts the host->device copies
   sixteenfold for the same bytes;
5. --gpubench h2d, d2h and both, staged and --gpudirect, at -b 16M -s 4g
   and at -b 4K -s 64M (-t 2 --iodepth 4): checks each run's bytes, ops
   and H2D/D2H path-audit counters, prints MiB/s, the share of the host
   link's bound (an assumed PCIe Gen5 x16, printed beside nvidia-smi's
   own reading of the link) where the copies cross the link every op, the op latency's p50/p99 and
   the dispatch and copy time per op; then traces a --gpudirect both run
   and checks that on every stream each D2H copy starts after the H2D
   copy from the same slot has ended;
6. --gpuprofile: a --gpuverify read of the main path's file, the
   headline --gpudirect read and --gpubench h2d, each one phase traced in
   a child process of its own; checks the trace subdirectories' names (the JAX package's),
   one H2D copy record per copy the counters report and one fingerprint
   kernel record per launch, and prints each phase's device busy share,
   its device time by kind, the host time in CUDA runtime calls, and the
   traced rate beside the untraced one;
7. flips one byte of the file and checks that the --gpuverify read fails,
   staged and through the fused ring with --gpudirect, with the kernel's
   integrity error and after launching the kernel;
8. drives the paths of the later slices through the CLI, each a main path
   of its own with the kernel's launch count zeroed before it and read
   after it: a write+read striped over four 1 GiB files; the sharded
   training-ingest dataset of the JAX package's `--scenario epochs`
   example (dir mode, 8 x 64 files of 16 MiB, docs/scenarios.md), with a
   corrupted file that the verify read must refuse; and a lots-of-small-
   files run (8 threads x 16 dirs x 512 files of 4 KiB through all six
   phases, toward the reference's LOSF sweep in BASELINE.md, cut to fit
   the smoke's time); each checks its entries, bytes, device copies and
   kernel launches, and prints which block loop it took (the dataset's
   and the small files' files are too short for the fused ring);
9. the slice phase, run between 6 and 7 on the main path's file:
   --gpuslice through the CLI on the 4 GiB file
   (docs/pod-slice.md's -t 4 -s 4G -b 16M, one device), --redistspec
   alltoall and replicate, through the fused ring and the preadv loop,
   checking that every byte is ingested and redistributed once in 256
   stripes with one fingerprint launch each (and one warm-up launch per
   run), and printing the rate, the
   redistribution's time per stripe and best rate beside a same-card
   copy's bound; then SliceRunner over 4 and 8 mesh slots on the card
   (16 MiB shards, every --redistspec): each device's data equals the
   plain version's, the fingerprint the host's, a flipped word is
   refused; then each collective --gpubench pattern (ici, allgather,
   reducescatter, alltoall, psum) at -s 1G -b 16M: bytes, ops, p50/p99,
   and one step against its plain version, and ici's and alltoall's
   copies over 8 slots of the card against theirs (chip_multigpu.py runs
   these paths over distinct cards);
10. runs the flagship step of entry() (xor scramble + the fingerprint
   kernel) at 1 MiB and 16 MiB: the scrambled block must equal numpy's
   xor, the (sum, xor) the plain version's and numpy's, one launch per
   call; its launches count in the kernel line;
11. prints the kernel line {"kernels": [...]} and, last, the result line
   {"ok": true, "device": {...}}.

Any failed phase exits nonzero. The whole run, kernel build included, must
end within TIME_LIMIT_S (1200 s) and fails past it; the passes are sized to
take about half of that, so that later passes fit beside them. The data
lives in _smoke_data/ of the checkout (listed in .gitignore) and is removed
at the end.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
MAIN_BLOCK = 16 << 20          # bytes per block on the main path (-b 16M)
MAIN_SIZE = 4 << 30            # -s 4g
MAIN_BLOCKS = MAIN_SIZE // MAIN_BLOCK
HBM_BYTES_PER_SEC = 3.35e12    # H100 SXM device memory, NVIDIA data sheet
DATASET_FILES = 8 * 64          # -t 8 -n 1 -N 64 of 16 MiB: 8 GiB
LOSF_FILES = 8 * 16 * 512      # -t 8 -n 16 -N 512 of 4 KiB
TIME_LIMIT_S = 1200            # the whole run, kernel build included
KERNEL_WORD_COUNTS = (1, 127, 128, 256, 1024, 4097, 262144, 4 << 20,
                      64 << 20)
# block sizes the kernel is timed at: the small-files pass's 4 KiB, 1-256 MiB
TIMING_BYTES = (4 << 10, 1 << 20, 4 << 20, 16 << 20, 64 << 20, 256 << 20)
TIMING_POOL = 512 << 20       # distinct bytes the timing rotates over (> L2)
TIMING_VIEWS = 4096           # at most this many distinct blocks per size
INTEGRITY_ERROR = "on-device integrity check failed"
PROFILE_MARGIN_S = 0.05        # idle host time at each end of a trace window
PROFILE_WARMUP_BYTES = 4       # CudaWorkerContext.profile_warmup's copy


class _Tee(io.TextIOBase):
    """A stream (stderr by default) whose text is also kept in ``text``."""

    def __init__(self, stream=None):
        self.text = io.StringIO()
        self._stream = stream or sys.stderr

    def write(self, s: str) -> int:
        self.text.write(s)
        return self._stream.write(s)

    def flush(self) -> None:
        self._stream.flush()


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int) -> "tuple[float, float]":
    """(device ms, host ms) per call of fn: medians over 3 rounds of
    `reps` calls, after a warm-up; round r calls fn(r * reps + i) for
    i < reps, so rounds take different blocks. Each round is queued
    behind a ~0.1 s device sleep, so the host has enqueued every call
    before the start event runs: the CUDA events then time the device
    work alone, and the host clock times the per-call launch cost."""
    import torch
    fn()
    torch.cuda.synchronize()
    rounds, host_rounds = [], []
    for r in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)  # cycles, ~0.1 s at H100 clocks
        start.record()
        t_host = time.perf_counter()
        for i in range(r * reps, (r + 1) * reps):
            fn(i)
        end.record()
        t_host = time.perf_counter() - t_host
        end.synchronize()
        device_ms = start.elapsed_time(end)
        if t_host * 1e3 > 50:
            fail(f"enqueueing {reps} calls took {t_host * 1e3:.1f} ms, "
                 f"longer than the device sleep ahead of them")
        rounds.append(device_ms / reps)
        host_rounds.append(t_host * 1e3 / reps)
    return statistics.median(rounds), statistics.median(host_rounds)


MASK = 0xFFFFFFFF


def rand_words(n: int, gen, dev):
    import torch
    return torch.randint(-(1 << 31), 1 << 31, (n,), dtype=torch.int32,
                         generator=gen, device=dev)


def check(words, what: str) -> "tuple[int, list[int]]":
    """Hold the kernel against its plain version on `words`, exactly."""
    from elbencho_tpu_torch.ops.verify import (fingerprint_u32,
                                               fingerprint_u32_plain)
    got_v = [v & MASK for v in fingerprint_u32(words).tolist()]
    want_v = [v & MASK for v in fingerprint_u32_plain(words).tolist()]
    err = max(abs(g - w) for g, w in zip(got_v, want_v))
    print(f"  {what:<40} kernel (sum={got_v[0]:#010x}, "
          f"xor={got_v[1]:#010x})  plain equal: {err == 0}")
    if err:
        fail(f"fingerprint kernel != plain version for {what}: "
             f"{got_v} vs {want_v}")
    return err, got_v


def check_chunk_edges(dev, gen) -> int:
    """Word counts one below and one above the edges of the kernel's
    plan (one step of a block, and the whole persistent grid's step:
    grid x threads x loads x 4 words), a few words, and the 1 KiB and
    4 KiB blocks of dir mode's small files, at every 4-byte offset from a
    16-byte boundary."""
    from elbencho_tpu_torch.ops.verify import TILE_VECS, launch_shape
    sms, per_sm = launch_shape(dev.index)
    edge = sms * per_sm * TILE_VECS * 4
    max_err = 0
    for n in (0, 2, 3, 5, 256, 1024, 4 * TILE_VECS - 1, 4 * TILE_VECS + 1,
              edge - 1, edge + 1):
        base = rand_words(n + 3, gen, dev)
        if base.data_ptr() % 16:
            fail("a fresh device allocation is not 16-byte aligned")
        for k in range(4):
            max_err = max(max_err, check(
                base[k:k + n], f"random, {n} words, {4 * k}-byte offset")[0])
    return max_err


def check_two_streams(dev, gen) -> None:
    """Two threads on two CUDA streams fingerprint two different 16 MiB
    blocks 100 times each at the same time: each stream's kernels wait
    behind a device sleep, so both queues drain together. Every result
    must equal that block's plain fingerprint (the kernel's scratch is
    per stream)."""
    import torch
    from elbencho_tpu_torch.ops.verify import (fingerprint_u32,
                                               fingerprint_u32_plain)
    blocks = [rand_words(MAIN_BLOCK // 4, gen, dev) for _ in range(2)]
    wants = [[v & MASK for v in fingerprint_u32_plain(b).tolist()]
             for b in blocks]
    if wants[0] == wants[1]:
        fail("the two blocks of the stream check have equal fingerprints")
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    torch.cuda.synchronize()
    start = threading.Barrier(2)
    results, errors = [None, None], []

    def worker(k):
        try:
            with torch.cuda.stream(streams[k]):
                torch.cuda._sleep(100_000_000)
                start.wait()
                outs = [fingerprint_u32(blocks[k]) for _ in range(100)]
                results[k] = torch.stack(outs).cpu()
        except BaseException as err:  # reported below, on the main thread
            errors.append(err)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        fail(f"the two-stream check raised {errors[0]!r}")
    for k in range(2):
        got = {tuple(v & MASK for v in row) for row in results[k].tolist()}
        if got != {tuple(wants[k])}:
            fail(f"two-stream check: stream {k} gave {sorted(got)}, want "
                 f"{wants[k]}")
    print("  two streams, 2 x 100 concurrent calls on two 16 MiB blocks: "
          "every result equals its block's plain fingerprint")


def show_one_launch_per_call(words) -> None:
    """Trace 10 calls with torch.profiler: each must enqueue the kernel
    and nothing else on the device (no zero fill), and the wrapper must
    count 10 launches. The trace window opens PROFILE_MARGIN_S before the
    first call and closes PROFILE_MARGIN_S after the device has finished
    the last: the profiler keeps only the kernel records that the device
    has delivered by the close and whose times, converted to the host
    clock, lie inside the window, so a kernel at either edge could
    otherwise go unrecorded though it ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from elbencho_tpu_torch.ops.verify import fingerprint_u32
    fingerprint_u32(words)
    torch.cuda.synchronize()
    launches = fingerprint_u32.launches.count
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        for _ in range(10):
            fingerprint_u32(words)
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    launches = fingerprint_u32.launches.count - launches
    events = prof.events()
    names = [e.name for e in events
             if e.device_type == torch.autograd.DeviceType.CUDA]
    runtime = sum("LaunchKernel" in e.name for e in events)
    ours = sum("fingerprint_u32_kernel" in n for n in names)
    others = sorted({n for n in names if "fingerprint_u32_kernel" not in n})
    if not names:
        fail("torch.profiler recorded no device activity for 10 calls, so "
             "one launch per call is not shown")
    print(f"  device activity of 10 calls (torch.profiler): {ours} "
          f"fingerprint kernels, other device work: {others or 'none'}; "
          f"{runtime} kernel launches on the host, {launches} counted by "
          f"the wrapper")
    if ours != 10 or others or launches != 10:
        fail(f"10 calls enqueued {ours} fingerprint kernels and {others} "
             f"(host launch records {runtime}, wrapper count {launches})")


def time_sizes(dev, gen) -> "dict[int, dict]":
    """Kernel, torch.sum (int64) and plain device ms per call at each
    size in TIMING_BYTES (keyed by bytes), rotating over distinct blocks
    of one 512 MiB pool so that each launch reads device memory, not L2
    (at 4 KiB the 600 blocks of a measurement, 2.4 MiB, may be in L2
    when torch.sum and the plain version read them after the kernel)."""
    import torch
    from elbencho_tpu_torch.ops.verify import (fingerprint_u32,
                                               fingerprint_u32_plain)
    pool = rand_words(TIMING_POOL // 4, gen, dev)
    rows = {}
    print("fingerprint_u32 by block size (device ms per call, bound = "
          "bytes / 3.35 TB/s; torch.sum int64 is the sum half only: no "
          "PyTorch call computes the xor reduction):")
    for size in TIMING_BYTES:
        n = size // 4
        k = min(TIMING_POOL // size, TIMING_VIEWS)
        blocks = [pool[i * n:(i + 1) * n] for i in range(k)]
        ms, host_ms = cuda_ms(lambda i=0: fingerprint_u32(blocks[i % k]),
                              200)
        library_ms, _ = cuda_ms(
            lambda i=0: torch.sum(blocks[i % k], dtype=torch.int64), 100)
        plain_ms, _ = cuda_ms(
            lambda i=0: fingerprint_u32_plain(blocks[i % k]), 10)
        bound_ms = size / HBM_BYTES_PER_SEC * 1e3
        rows[size] = {"ms": ms, "bound_ms": bound_ms, "plain_ms": plain_ms,
                      "library_ms": library_ms}
        label = f"{size >> 10} KiB" if size < 1 << 20 else \
            f"{size >> 20} MiB"
        print(f"  {label:>7} ({k:>4} distinct blocks): kernel {ms:.4f} "
              f"ms, bound {bound_ms:.4f} ms, {bound_ms / ms:.1%} of the "
              f"bound, {size / ms / 1e6:.1f} GB/s; torch.sum int64 "
              f"{library_ms:.4f} ms; plain {plain_ms:.4f} ms; the "
              f"wrapper's host cost {host_ms * 1e3:.1f} us per call")
    del pool, blocks
    return rows


def kernel_phase(dev) -> dict:
    import torch
    from elbencho_tpu_torch.ops.cuda_build import build_reports
    from elbencho_tpu_torch.ops.verify import (expected_fingerprint_host,
                                               fingerprint_plan,
                                               launch_shape, load_kernel)
    t0 = time.monotonic()
    load_kernel()
    build_secs, report = build_reports["fingerprint"]
    print(f"kernel build: fingerprint.cu {build_secs:.1f} s "
          f"(load {time.monotonic() - t0:.1f} s)")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  ptxas: {line.strip()}")
    sms, per_sm = launch_shape(dev.index)
    print(f"  persistent grid: {sms} SMs x {per_sm} blocks per SM; plan at "
          f"16 MiB: {fingerprint_plan(MAIN_BLOCK // 4, 0, sms, per_sm)}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    max_err = 0
    print("fingerprint kernel vs plain version (tolerance 0):")
    for n in KERNEL_WORD_COUNTS:
        max_err = max(max_err, check(rand_words(n, gen, dev),
                                     f"random, {n} words")[0])
    for n in (4097, 4 << 20):
        for name, fill in (("all-ones", -1), ("all-zeros", 0)):
            x = torch.full((n,), fill, dtype=torch.int32, device=dev)
            max_err = max(max_err, check(x, f"{name}, {n} words")[0])
    base = rand_words(4098, gen, dev)
    max_err = max(max_err, check(base[1:], "4097 words, 4-byte offset")[0])
    max_err = max(max_err, check_chunk_edges(dev, gen))

    # a flipped bit must change the fingerprint
    from elbencho_tpu_torch.ops.fill import verify_pattern_block_u32
    block = verify_pattern_block_u32(12345 * MAIN_BLOCK + 7, 4 << 20, dev)
    want = expected_fingerprint_host(12345 * MAIN_BLOCK, MAIN_BLOCK, 7)
    _, before = check(block, "16 MiB verify pattern")
    if tuple(before) != want:
        fail(f"fingerprint of the verify pattern {before} != closed form "
             f"{want}")
    block[777777] ^= 1 << 13
    _, after = check(block, "16 MiB pattern, one bit flipped")
    if after[0] == before[0] or after[1] == before[1]:
        fail("a flipped bit was not caught by the fingerprint")
    print("  flipped bit caught: sum and xor both changed")

    check_two_streams(dev, gen)
    show_one_launch_per_call(block)
    rows = time_sizes(dev, gen)
    host_secs = []
    for k in range(5):
        t = time.perf_counter()
        expected_fingerprint_host(k * MAIN_BLOCK, MAIN_BLOCK, 7)
        host_secs.append(time.perf_counter() - t)
    print(f"expected_fingerprint_host at 16 MiB (host): "
          f"{statistics.median(host_secs) * 1e3:.2f} ms median of 5")
    main = rows[MAIN_BLOCK]
    return {"name": "fingerprint_u32", "route": "cuda",
            "source": "elbencho_tpu_torch/csrc/fingerprint.cu",
            "replaces": "elbencho_tpu/ops/verify.py:39",
            "max_abs_err": max_err, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": "bytes", "library_ms": main["library_ms"]}


def check_registered_slot(dev) -> None:
    import torch
    from elbencho_tpu_torch.cuda.device import CudaWorkerContext
    from elbencho_tpu_torch.utils.staging_pool import StagingPool
    pool = StagingPool(2, MAIN_BLOCK)
    ctx = CudaWorkerContext(chip_id=dev.index, block_size=MAIN_BLOCK,
                            direct=True, staging_pool=pool)
    try:
        slot = torch.frombuffer(pool.views[1], dtype=torch.uint8)
        if not (pool.registered and slot.is_pinned()):
            fail("a --gpudirect I/O slot is not page-locked (is_pinned)")
        print("registered I/O slot: is_pinned() True")
        del slot
    finally:
        ctx.close()
        pool.close()


def run_cli(args: "list[str]", json_path: str) -> "tuple[int, list[dict]]":
    from elbencho_tpu_torch.cli import main as cli_main
    if os.path.exists(json_path):
        os.unlink(json_path)
    rc = cli_main(args + ["--nolive", "--jsonfile", json_path])
    recs = []
    if os.path.exists(json_path):
        with open(json_path) as f:
            recs = [json.loads(line) for line in f]
    return rc, recs


def main_path(work: str, untraced: dict) -> int:
    """Drive the port's CLI; returns the fingerprint launches of the run,
    and keeps the first pass's READ rate in ``untraced`` (for the traced
    --gpuverify read of the same file)."""
    from elbencho_tpu_torch.ops.verify import fingerprint_u32
    path = os.path.join(work, "smoke.bin")
    common = ["-t", "2", "-b", "16M", "-s", f"{MAIN_SIZE >> 20}M",
              "--iodepth", "4", "--gpuids", "0", path]
    verify = ["--verify", "7", "--gpuverify"]
    # the fused ring first, then the verify passes again through the
    # Python loop, which serves every phase the ring cannot take
    passes = (
        ("write+read, --gpuverify", ["-w", "-r", *verify], MAIN_BLOCKS),
        ("read, --gpudirect --gpuverify", ["-r", "--gpudirect", *verify],
         MAIN_BLOCKS),
        ("write+read, device fill pool", ["-w", "-r"], 0),
        ("write+read, --gpuverify, Python loop",
         ["-w", "-r", *verify, "--gpustream", "off"], MAIN_BLOCKS),
        ("read, --gpudirect --gpuverify, Python loop",
         ["-r", "--gpudirect", *verify, "--gpustream", "off"], MAIN_BLOCKS),
    )
    launches_before = 0
    fingerprint_u32.launches.reset()
    for i, (name, flags, want_launches) in enumerate(passes):
        fused = "off" not in flags
        if fused:
            flags = flags + ["--gpustream", "on"]
        t0 = time.monotonic()
        rc, recs = run_cli(flags + common,
                           os.path.join(work, f"pass{i}.json"))
        secs = time.monotonic() - t0
        if rc != 0:
            fail(f"main path pass '{name}' exited {rc}")
        launches = fingerprint_u32.launches.count - launches_before
        launches_before = fingerprint_u32.launches.count
        print(f"main path pass '{name}': {secs:.1f} s, fingerprint "
              f"launches {launches}")
        want_phases = ["WRITE", "READ"] if "-w" in flags else ["READ"]
        if [r["Phase"] for r in recs] != want_phases:
            fail(f"pass '{name}' recorded phases "
                 f"{[r['Phase'] for r in recs]}, want {want_phases}")
        for rec in recs:
            is_read = rec["Phase"] == "READ"
            ops = sum(rec[k] for k in (
                ("TpuH2dDirectOps", "TpuH2dStagedOps") if is_read
                else ("TpuD2hDirectOps", "TpuD2hStagedOps")))
            print(f"  {rec['Phase']:<5} storage {rec['MiBPerSecLast']} "
                  f"MiB/s, device {rec['TpuHbmMiBPerSec']} MiB/s, "
                  f"{rec['IOLatHisto']['LatNumValues']} ops, "
                  f"{rec['BytesLast']} bytes, device ops {ops}, "
                  f"dispatch {rec['TpuDispatchUSec'] / max(ops, 1):.1f} "
                  f"us/op, copy {rec['TpuTransferUSec'] / max(ops, 1):.1f} "
                  f"us/op, H2D direct {rec['TpuH2dDirectOps']}, "
                  f"D2H direct {rec['TpuD2hDirectOps']}, prefetch hits "
                  f"{rec['TpuD2hPrefetchHits']}, inflight hwm "
                  f"{rec['TpuPipeInflightHwm']}, full stalls "
                  f"{rec['TpuPipeFullStalls']}, {loop_taken(rec)}, on "
                  f"{rec['Device']}")
            if rec["TpuStreamFusedOps"] != (MAIN_BLOCKS if fused else 0):
                fail(f"pass '{name}' {rec['Phase']}: "
                     f"{rec['TpuStreamFusedOps']} ops through the fused "
                     f"ring, want {MAIN_BLOCKS if fused else 0}")
            if rec["BytesLast"] != MAIN_SIZE \
                    or rec["TpuHbmBytes"] != MAIN_SIZE \
                    or rec["IOLatHisto"]["LatNumValues"] != MAIN_BLOCKS \
                    or ops != MAIN_BLOCKS:
                fail(f"pass '{name}' {rec['Phase']}: wrong bytes or ops")
            if is_read and rec["TpuPipeInflightHwm"] < 2:
                fail(f"pass '{name}': transfers did not overlap")
            if "--gpudirect" in flags and rec["TpuH2dDirectOps"] == 0:
                fail(f"pass '{name}': no direct H2D copy ran")
            if "cuda" not in rec["Device"]:
                fail(f"pass '{name}' did not run on a CUDA device")
            if i == 0 and is_read:
                untraced["read, --gpuverify"] = rec["TpuHbmMiBPerSec"]
        if launches != want_launches:
            fail(f"pass '{name}': {launches} fingerprint launches, want "
                 f"{want_launches} (one per block read under --gpuverify)")
    return fingerprint_u32.launches.count


def loop_taken(rec: dict) -> str:
    """Which block loop served a device phase's storage ops."""
    fused = rec["TpuStreamFusedOps"]
    return f"fused ring ({fused} ops)" if fused else "Python loop"


def headline_pass(work: str, backend: str, untraced: dict) -> None:
    """bench.py's headline shape, a plain -r -t 2 -b 16M --iodepth 4 read
    of the main path's 4 GiB file, staged and --gpudirect, through the
    fused ring and through the Python loop: three runs of each, in
    alternating order; prints each one's medians and the ring's backend
    as the ring's log line reports it, and fails unless that is
    `backend`, the engine's probed stream backend. No claim rests on the
    rates. Keeps each run's median device rate in ``untraced``."""
    path = os.path.join(work, "smoke.bin")
    configs = (("staged, fused ring", ["--gpustream", "on"]),
               ("staged, Python loop", ["--gpustream", "off"]),
               ("--gpudirect, fused ring", ["--gpudirect", "--gpustream",
                                            "on"]),
               ("--gpudirect, Python loop", ["--gpudirect", "--gpustream",
                                             "off"]))
    recs = {name: [] for name, _ in configs}
    engaged = set()
    for rep in range(3):
        for name, flags in configs if rep % 2 == 0 else configs[::-1]:
            out = _Tee(sys.stdout)
            with contextlib.redirect_stdout(out):
                (rec,), _ = run_pass(
                    f"headline read, {name}",
                    ["-r", "-t", "2", "-b", "16M", "--iodepth", "4",
                     "--gpuids", "0", *flags, path],
                    os.path.join(work, "headline.json"), ["READ"])
            fused = "fused" in name
            expect(name, rec, BytesLast=MAIN_SIZE, TpuHbmBytes=MAIN_SIZE,
                   ops=MAIN_BLOCKS, device_ops=MAIN_BLOCKS,
                   TpuStreamFusedOps=MAIN_BLOCKS if fused else 0,
                   TpuH2dDirectOps=MAIN_BLOCKS if "direct" in name else 0)
            recs[name].append(rec)
            engaged.update(line.split("fused GPU stream engaged ")[1]
                           for line in out.text.getvalue().splitlines()
                           if "fused GPU stream engaged " in line)
    print("headline read (-r -t 2 -b 16M --iodepth 4, 4 GiB), medians of "
          "3 runs in alternating order:")
    for name, _ in configs:
        runs = recs[name]

        def med(fn, runs=runs):
            return statistics.median(fn(r) for r in runs)
        print(f"  {name:<24} storage {med(lambda r: r['MiBPerSecLast'])} "
              f"MiB/s (runs: {[r['MiBPerSecLast'] for r in runs]}), device "
              f"{med(lambda r: r['TpuHbmMiBPerSec'])} MiB/s, dispatch "
              f"{med(lambda r: r['TpuDispatchUSec'] / MAIN_BLOCKS):.1f} "
              f"us/op, copy "
              f"{med(lambda r: r['TpuTransferUSec'] / MAIN_BLOCKS):.1f} "
              f"us/op, inflight hwm {med(lambda r: r['TpuPipeInflightHwm'])}"
              f", full stalls {med(lambda r: r['TpuPipeFullStalls'])}")
        untraced[f"headline read, {name}"] = med(
            lambda r: r["TpuHbmMiBPerSec"])
    if not engaged:
        fail("the fused headline reads logged no engaged stream ring")
    if any(f"backend={backend}," not in e for e in engaged):
        fail(f"the fused headline reads ran {sorted(engaged)}, not the "
             f"engine's probed backend {backend}")
    # ABI 11 has no accessor for the ring's fixed-file registration
    print(f"  stream ring: {sorted(engaged)}; fixed_files: not reported "
          f"by the engine (ABI 11 has no accessor)")


def device_ops(rec: dict) -> int:
    """Host->device copies of a READ record, device->host of a WRITE."""
    keys = ("TpuH2dDirectOps", "TpuH2dStagedOps") if rec["Phase"] == "READ" \
        else ("TpuD2hDirectOps", "TpuD2hStagedOps")
    return sum(rec[k] for k in keys)


def run_pass(name: str, args: "list[str]", json_path: str,
             want_phases: "list[str]") -> "tuple[list[dict], int]":
    """One CLI run with the kernel's launch count zeroed just before it and
    read just after it; fails unless it exits 0 with `want_phases` on a
    CUDA device. Returns (records, fingerprint launches)."""
    from elbencho_tpu_torch.ops.verify import fingerprint_u32
    fingerprint_u32.launches.reset()
    t0 = time.monotonic()
    rc, recs = run_cli(args, json_path)
    secs = time.monotonic() - t0
    launches = fingerprint_u32.launches.count
    if rc != 0:
        fail(f"pass '{name}' exited {rc}")
    if [r["Phase"] for r in recs] != want_phases:
        fail(f"pass '{name}' recorded phases {[r['Phase'] for r in recs]}, "
             f"want {want_phases}")
    print(f"pass '{name}': {secs:.1f} s, fingerprint launches {launches}")
    for rec in recs:
        ops = max(device_ops(rec), 1)
        if "cuda" not in rec["Device"]:
            fail(f"pass '{name}' {rec['Phase']} did not run on a CUDA device")
        print(f"  {rec['Phase']:<8} {rec['EntriesLast']} entries, "
              f"{rec['EntriesPerSecLast']} entries/s, {rec['BytesLast']} "
              f"bytes, storage {rec['MiBPerSecLast']} MiB/s, device "
              f"{rec['TpuHbmMiBPerSec']} MiB/s, {rec['TpuHbmBytes']} device "
              f"bytes, {rec['IOLatHisto']['LatNumValues']} ops, device ops "
              f"{device_ops(rec)} (H2D direct {rec['TpuH2dDirectOps']}), "
              f"dispatch {rec['TpuDispatchUSec'] / ops:.1f} us/op, copy "
              f"{rec['TpuTransferUSec'] / ops:.1f} us/op, "
              f"{loop_taken(rec)}, "
              f"entry latency avg {rec['EntLatUSecAvg']} us, max "
              f"{rec['EntLatUSecMax']} us, elapsed {rec['ElapsedUSecLast']} "
              f"us")
    return recs, launches


def expect(name: str, rec: dict, **want) -> None:
    """Fail unless every key of `want` has its value in `rec` (the key
    "ops" is the record's number of storage ops, "device_ops" its copies)."""
    for key, value in want.items():
        got = rec["IOLatHisto"]["LatNumValues"] if key == "ops" \
            else device_ops(rec) if key == "device_ops" else rec[key]
        if got != value:
            fail(f"pass '{name}' {rec['Phase']}: {key} is {got}, want "
                 f"{value}")


def gpubatch_pass(work: str) -> None:
    """Read the main path's 4 GiB file in 1 MiB blocks, without and with
    --gpubatch 16, staged and --gpudirect, through the fused ring, and
    --gpubatch 16 once more through the Python loop: the batch cuts the
    copies from 4096 to 256 (a partial last batch would show as one more)
    for the same device bytes. No claim rests on the rates printed."""
    path = os.path.join(work, "smoke.bin")
    blocks = MAIN_SIZE >> 20
    for direct in ([], ["--gpudirect"]):
        for batch, copies, stream in ((1, blocks, "auto"),
                                      (16, blocks // 16, "auto"),
                                      (16, blocks // 16, "off")):
            mode = f"--gpubatch {batch}{' --gpudirect' if direct else ''}" \
                f"{' --gpustream off' if stream == 'off' else ''}"
            name = f"1 MiB read, {mode}"
            (rec,), _ = run_pass(
                name, ["-r", "-t", "2", "-b", "1M", "--iodepth", "4",
                       "--gpuids", "0", "--gpubatch", str(batch), *direct,
                       "--gpustream", stream, path],
                os.path.join(work, "batch.json"), ["READ"])
            expect(name, rec, BytesLast=MAIN_SIZE, TpuHbmBytes=MAIN_SIZE,
                   ops=blocks, device_ops=copies,
                   TpuStreamFusedOps=0 if stream == "off" else blocks)
            if direct and rec["TpuH2dDirectOps"] != copies:
                fail(f"pass '{name}': {rec['TpuH2dDirectOps']} direct "
                     f"copies, want {copies}")
            print(f"  {mode}: {rec['TpuHbmMiBPerSec']} MiB/s into the "
                  f"device, {copies} copies")


def striped_pass(work: str) -> int:
    """Write and --gpuverify read striped over four 1 GiB files, then
    delete them; returns the fingerprint launches."""
    paths = [os.path.join(work, f"f{i}") for i in range(4)]
    name = "striped write+read over 4 files"
    recs, launches = run_pass(
        name, ["-w", "-r", "-F", "-t", "2", "-b", "16M", "-s", "1g",
               "--iodepth", "4", "--verify", "7", "--gpuverify", "--gpuids",
               "0", *paths],
        os.path.join(work, "stripe.json"), ["WRITE", "READ", "RMFILES"])
    for rec in recs[:2]:
        expect(name, rec, BytesLast=MAIN_SIZE, TpuHbmBytes=MAIN_SIZE,
               ops=MAIN_BLOCKS, device_ops=MAIN_BLOCKS,
               TpuStreamFusedOps=MAIN_BLOCKS)
    expect(name, recs[2], EntriesLast=4)
    if launches != MAIN_BLOCKS:
        fail(f"pass '{name}': {launches} fingerprint launches, want "
             f"{MAIN_BLOCKS}")
    if any(os.path.exists(p) for p in paths):
        fail(f"pass '{name}' left files behind")
    return launches


def dataset_pass(work: str) -> int:
    """The sharded training-ingest dataset (dir mode, 512 files of 16 MiB)
    written and read under --gpuverify, one file corrupted and the read
    refused, then deleted; returns the clean read's fingerprint launches."""
    bench = os.path.join(work, "dataset")
    os.makedirs(bench)
    flags = ["-t", "8", "-n", "1", "-N", "64", "-s", "16M", "-b", "16M",
             "--iodepth", "4", "--verify", "7", "--gpuids", "0"]
    size = DATASET_FILES * MAIN_BLOCK
    name = "dataset write+read, dir mode"
    recs, launches = run_pass(
        name, ["-d", "-w", "-r", "--gpuverify", *flags, bench],
        os.path.join(work, "dataset.json"), ["MKDIRS", "WRITE", "READ"])
    expect(name, recs[0], EntriesLast=8)
    for rec in recs[1:]:
        # a file of one 16 MiB block is shorter than two ring-fills
        expect(name, rec, EntriesLast=DATASET_FILES, BytesLast=size,
               TpuHbmBytes=size, ops=DATASET_FILES,
               device_ops=DATASET_FILES, TpuStreamFusedOps=0)
    if launches != DATASET_FILES:
        fail(f"pass '{name}': {launches} fingerprint launches, want "
             f"{DATASET_FILES}")
    print(f"  dataset READ: {recs[2]['MiBPerSecLast']} MiB/s storage, "
          f"{recs[2]['TpuHbmMiBPerSec']} MiB/s into the device")

    victim = os.path.join(bench, "r5", "d0", "r5-f37")
    with open(victim, "r+b") as f:
        f.seek(9 << 20)
        byte = f.read(1)
        f.seek(9 << 20)
        f.write(bytes([byte[0] ^ 0x04]))
    from elbencho_tpu_torch.ops.verify import fingerprint_u32
    fingerprint_u32.launches.reset()
    err = _Tee()
    with contextlib.redirect_stderr(err):
        rc, _ = run_cli(["-r", "--gpuverify", *flags, bench],
                        os.path.join(work, "dataset-corrupt.json"))
    bad = fingerprint_u32.launches.count
    want_err = f"{INTEGRITY_ERROR} for block at offset 0"
    if rc == 0:
        fail("the --gpuverify read of a dataset with a corrupted file "
             "succeeded")
    if want_err not in err.text.getvalue():
        fail(f"the dataset read with a corrupted file failed (rc {rc}), but "
             f"not with '{want_err}'")
    if bad == 0:
        fail("the corrupted dataset read failed without a fingerprint "
             "launch")
    print(f"corrupted dataset file: --gpuverify read failed as it must (rc "
          f"{rc}, '{want_err}' after {bad} fingerprint launches)")

    name = "dataset delete, dir mode"
    recs, _ = run_pass(name, ["-F", "-D", *flags, bench],
                       os.path.join(work, "dataset-rm.json"),
                       ["RMFILES", "RMDIRS"])
    expect(name, recs[0], EntriesLast=DATASET_FILES)
    expect(name, recs[1], EntriesLast=8)
    if os.listdir(bench):
        fail(f"the dataset directory is not empty after RMDIRS: "
             f"{os.listdir(bench)[:5]}")
    return launches


def losf_pass(work: str) -> int:
    """Lots of small files through all six phases; returns the READ's
    fingerprint launches."""
    bench = os.path.join(work, "losf")
    os.makedirs(bench)
    name = "lots of small files, dir mode"
    recs, launches = run_pass(
        name, ["-d", "-w", "--stat", "-r", "-F", "-D", "-t", "8", "-n", "16",
               "-N", "512", "-s", "4K", "-b", "4K", "--verify", "7",
               "--gpuverify", "--gpuids", "0", bench],
        os.path.join(work, "losf.json"),
        ["MKDIRS", "WRITE", "STAT", "READ", "RMFILES", "RMDIRS"])
    for rec in recs:
        want = 8 * 16 if rec["Phase"] in ("MKDIRS", "RMDIRS") else LOSF_FILES
        expect(name, rec, EntriesLast=want, TpuStreamFusedOps=0)
    expect(name, recs[3], device_ops=LOSF_FILES, TpuHbmBytes=LOSF_FILES << 12)
    if launches != LOSF_FILES:
        fail(f"pass '{name}': {launches} fingerprint launches, want "
             f"{LOSF_FILES}")
    print("  entries/s: " + ", ".join(
        f"{r['Phase']} {r['EntriesPerSecLast']}" for r in recs))
    if os.listdir(bench):
        fail("the LOSF directory is not empty after RMDIRS")
    return launches


#: an H100's host link, PCIe Gen5 x16: 32 GT/s x 16 lanes x 128/130 / 8
PCIE_GEN5_X16_BYTES_PER_SEC = 32e9 * 16 * 128 / 130 / 8


def pcie_link() -> str:
    """nvidia-smi's own line for the card's PCIe link, printed beside the
    assumed Gen5 x16 bound (the chip machine reported no link)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=pcie.link.gen.max,"
             "pcie.link.width.max", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        out = f"not read ({err})"
    return out or "empty"


def bench_run(name: str, args: "list[str]", json_path: str) -> dict:
    """One --gpubench CLI run; fails unless it exits 0 with one TPUBENCH
    record on a CUDA device. Returns the record."""
    t0 = time.monotonic()
    rc, recs = run_cli(args, json_path)
    if rc != 0:
        fail(f"pass '{name}' exited {rc}")
    if [r["Phase"] for r in recs] != ["TPUBENCH"]:
        fail(f"pass '{name}' recorded phases {[r['Phase'] for r in recs]}, "
             f"want ['TPUBENCH']")
    if "cuda" not in recs[0]["Device"]:
        fail(f"pass '{name}' did not run on a CUDA device")
    recs[0]["secs"] = time.monotonic() - t0
    return recs[0]


#: --gpubench shapes: the main path's block and size, and a 4 KiB block
GPUBENCH_SHAPES = ((MAIN_BLOCK, MAIN_SIZE), (4 << 10, 64 << 20))
GPUBENCH_THREADS = 2


def gpubench_pass(work: str) -> dict:
    """--gpubench h2d, d2h and both, staged and --gpudirect, at -b 16M -s
    4g and -b 4K -s 64M (-t 2 --iodepth 4, as on the main path): each
    run's bytes, ops and H2D/D2H path-audit counters must be what its
    arguments imply. Prints MiB/s, the share of the link's bound where
    the copies cross the link every op (a staged d2h copies from the fill
    pool's host mirror, filled once: a host memcpy), the op latency's
    p50/p99 and the dispatch and copy time per op. Then a traced
    --gpudirect both run: on every stream each D2H copy must start after
    the H2D copy before it, from the same slot, has ended. Returns the
    records by (pattern, direct, block)."""
    from elbencho_tpu_torch.stats.latency_histogram import LatencyHistogram
    link_rate = PCIE_GEN5_X16_BYTES_PER_SEC
    print(f"host link: ASSUMED PCIe Gen5 x16, {link_rate / 1e9:.2f} GB/s "
          f"per direction; nvidia-smi pcie.link.gen.max, width.max: "
          f"{pcie_link()}")
    out = {}
    for block, size in GPUBENCH_SHAPES:
        ops = GPUBENCH_THREADS * -(-size // block)
        for direct in (False, True):
            for pattern in ("h2d", "d2h", "both"):
                mode = f"{pattern}{', --gpudirect' if direct else ''}"
                label = f"{block >> 10} KiB" if block < 1 << 20 else \
                    f"{block >> 20} MiB"
                name = f"--gpubench {mode}, {label} blocks"
                rec = bench_run(name, [
                    "--gpubench", "--gpubenchpat", pattern, "-t",
                    str(GPUBENCH_THREADS), "-b", str(block), "-s", str(size),
                    "--iodepth", "4", "--gpuids", "0",
                    *(["--gpudirect"] if direct else [])],
                    os.path.join(work, "gpubench.json"))
                h2d = ops if pattern in ("h2d", "both") else 0
                d2h = ops if pattern in ("d2h", "both") else 0
                moved = GPUBENCH_THREADS * size * (2 if pattern == "both"
                                                   else 1)
                expect(name, rec, BytesLast=moved, TpuHbmBytes=moved,
                       ops=ops, TpuStreamFusedOps=0,
                       TpuH2dDirectOps=h2d if direct else 0,
                       TpuH2dStagedOps=0 if direct else h2d,
                       TpuD2hDirectOps=d2h if direct else 0,
                       TpuD2hStagedOps=0 if direct else d2h)
                histo = LatencyHistogram.from_dict(rec["IOLatHisto"])
                if pattern == "h2d" or (pattern == "d2h" and direct):
                    link_share = rec["TpuHbmMiBPerSec"] * (1 << 20) \
                        / link_rate
                    share = f"{link_share:.1%} of the link"
                elif direct:
                    share = "no link share (both directions per op)"
                else:
                    share = "no link share (its D2H is a host memcpy)"
                print(f"  {name:<34} {rec['TpuHbmMiBPerSec']} MiB/s, "
                      f"{share}; op latency p50 "
                      f"{histo.percentile(50):.1f} us, p99 "
                      f"{histo.percentile(99):.1f} us ({ops} ops); "
                      f"dispatch {rec['TpuDispatchUSec'] / ops:.1f} us/op, "
                      f"copy {rec['TpuTransferUSec'] / ops:.1f} us/op; "
                      f"{rec['secs']:.1f} s")
                out[pattern, direct, block] = rec
    ordering_check(work)
    return out


#: trace event categories of work on the device (CUPTI's records)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load_trace(trace_dir: str, want: "list[str]") -> "dict[str, list]":
    """The complete events of each traced phase of one --gpuprofile run
    (``want``: the subdirectory names, as the JAX package names them),
    keyed by subdirectory; fails when a subdirectory or its trace is
    missing, or a trace holds no device record."""
    got = sorted(os.listdir(trace_dir)) if os.path.isdir(trace_dir) else []
    if got != want:
        fail(f"--gpuprofile wrote {got}, want {want}")
    out = {}
    for name in want:
        path = os.path.join(trace_dir, name, "trace.json")
        if not os.path.exists(path):
            fail(f"--gpuprofile wrote no trace into {name}")
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        out[name] = [e for e in events if e.get("ph") == "X"]
        if not any(e.get("cat") in DEVICE_CATS for e in out[name]):
            fail(f"the --gpuprofile trace {name} holds no device record")
    return out


#: the CLI in a child process that prints its kernel launches at the end
_CHILD_CLI = ("import sys; from elbencho_tpu_torch.cli import main; "
              "from elbencho_tpu_torch.ops.verify import fingerprint_u32; "
              "rc = main(sys.argv[1:]); "
              "print('FINGERPRINT_LAUNCHES', fingerprint_u32.launches.count); "
              "sys.exit(rc)")


def traced_run(name: str, args: "list[str]", work: str,
               want: "list[str]") -> "tuple[list, int, dict]":
    """One --gpuprofile run of the CLI in a fresh child process, as a
    user runs it: in one process that had already traced several phases,
    torch.profiler lost the records of a thread's first copies of a later
    trace (PERF.md section 7). Fails unless it exits 0 with the trace
    subdirectories ``want`` on a CUDA device. Returns (records, the
    child's fingerprint launches, trace events by subdirectory)."""
    trace_dir = tempfile.mkdtemp(prefix="trace-", dir=work)
    json_path = os.path.join(work, "traced.json")
    if os.path.exists(json_path):
        os.unlink(json_path)
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD_CLI, *args, "--nolive", "--jsonfile",
         json_path, "--gpuprofile", trace_dir],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr)
    if proc.returncode != 0:
        fail(f"traced run '{name}' exited {proc.returncode}")
    launches = int(proc.stdout.rsplit("FINGERPRINT_LAUNCHES", 1)[1].split()[0])
    with open(json_path) as f:
        recs = [json.loads(line) for line in f]
    if any("cuda" not in r["Device"] for r in recs):
        fail(f"traced run '{name}' did not run on a CUDA device")
    return recs, launches, load_trace(trace_dir, want)


def is_profile_warmup(event: dict) -> bool:
    """The one 4-byte H2D copy each worker thread makes at the start of a
    traced phase, not a copy the counters report."""
    return event.get("cat") == "gpu_memcpy" and "HtoD" in event["name"] \
        and event["args"].get("bytes") == PROFILE_WARMUP_BYTES


def ordering_check(work: str) -> None:
    """A traced --gpudirect both run (-b 16M -s 1g, -t 2): on each stream
    the copies alternate H2D, D2H, and each D2H starts after its H2D,
    which reads the same registered slot, has ended."""
    (rec,), _, traces = traced_run(
        "--gpubench both, --gpudirect", [
            "--gpubench", "--gpubenchpat", "both", "-t", "2", "-b", "16M",
            "-s", "1g", "--iodepth", "4", "--gpuids", "0", "--gpudirect"],
        work, ["001_tpubench"])
    by_stream: "dict[int, list]" = {}
    for e in traces["001_tpubench"]:
        if e.get("cat") == "gpu_memcpy" and not is_profile_warmup(e):
            by_stream.setdefault(e["args"].get("stream", e.get("tid")),
                                 []).append(e)
    n_ops = 0
    for stream, evs in by_stream.items():
        evs.sort(key=lambda e: e["ts"])
        kinds = ["HtoD" if "HtoD" in e["name"] else "DtoH" if "DtoH" in
                 e["name"] else e["name"] for e in evs]
        if kinds != ["HtoD", "DtoH"] * (len(evs) // 2):
            fail(f"--gpudirect both, stream {stream}: the copies do not "
                 f"alternate H2D, D2H: {kinds[:8]}...")
        for h2d, d2h in zip(evs[::2], evs[1::2]):
            if d2h["ts"] < h2d["ts"] + h2d["dur"]:
                fail(f"--gpudirect both, stream {stream}: a D2H copy "
                     f"started at {d2h['ts']} us, before the H2D copy "
                     f"from its slot ended at {h2d['ts'] + h2d['dur']} us")
        n_ops += len(evs) // 2
    if n_ops != rec["TpuH2dDirectOps"] or n_ops != rec["TpuD2hDirectOps"] \
            or n_ops != 2 * (1 << 30) // MAIN_BLOCK:
        fail(f"--gpudirect both: the trace holds {n_ops} H2D+D2H pairs, "
             f"the counters {rec['TpuH2dDirectOps']} H2D and "
             f"{rec['TpuD2hDirectOps']} D2H copies")
    print(f"  --gpudirect both, traced: {n_ops} ops on {len(by_stream)} "
          f"streams, each D2H after its H2D from the same slot")


def busy_share(events: list, elapsed_usec: int) -> "tuple[float, dict]":
    """The device's busy share of a phase: the union of its device
    records' intervals over the phase's wall time; and the device time by
    kind."""
    events = [e for e in events if e.get("cat") in DEVICE_CATS]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    kinds: "dict[str, float]" = {}
    for e in events:
        kind = e["cat"] if e["cat"] != "gpu_memcpy" else e["name"].split(
            " (")[0]
        kinds[kind] = kinds.get(kind, 0.0) + e["dur"]
    return busy / max(elapsed_usec, 1), kinds


def runtime_totals(events: list) -> "dict[str, float]":
    """Host time (us) in the four costliest CUDA runtime calls of a traced
    phase, over all threads: a wait shows as cudaMemcpyAsync (a result
    read to the host) or cudaEventSynchronize (the transfer ring)."""
    totals: "dict[str, float]" = {}
    for e in events:
        if e.get("cat") == "cuda_runtime":
            totals[e["name"]] = totals.get(e["name"], 0.0) + e["dur"]
    return dict(sorted(totals.items(), key=lambda kv: -kv[1])[:4])


def gpuprofile_pass(work: str, untraced: dict) -> None:
    """Three --gpuprofile runs of the CLI, each in a child process and
    each tracing one phase, the first of its process (later traces of one
    process lost records, see traced_run): a --gpuverify read of the main
    path's file (the fused ring), the headline --gpudirect read, and
    --gpubench h2d. The subdirectories must carry the JAX package's
    names; each trace one H2D copy record per copy the counters report,
    and one fingerprint kernel record per launch. Prints each traced
    phase's device busy share and its rate beside the untraced run's
    (``untraced``: rates by run name)."""
    path = os.path.join(work, "smoke.bin")
    common = ["-t", "2", "-b", "16M", "--iodepth", "4", "--gpuids", "0"]
    runs = (
        ("read, --gpuverify", ["-r", "--verify", "7", "--gpuverify",
                               "--gpustream", "on", *common, path],
         ["001_readfiles"]),
        ("headline read, --gpudirect, fused ring",
         ["-r", "--gpudirect", "--gpustream", "on", *common, path],
         ["001_readfiles"]),
        ("--gpubench h2d", ["--gpubench", "--gpubenchpat", "h2d", "-s",
                            f"{MAIN_SIZE >> 20}M", *common],
         ["001_tpubench"]),
    )
    print("traced runs (--gpuprofile, torch.profiler with CPU and CUDA "
          "activity):")
    for name, args, dirs in runs:
        recs, launches, traces = traced_run(name, args, work, dirs)
        for rec, sub in zip(recs, dirs, strict=True):
            events = traces[sub]
            warmups = sum(map(is_profile_warmup, events))
            h2d = sum(e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]
                      for e in events) - warmups
            kernels = sum(e.get("cat") == "kernel" and
                          "fingerprint_u32_kernel" in e["name"]
                          for e in events)
            copies = rec["TpuH2dDirectOps"] + rec["TpuH2dStagedOps"]
            if h2d != copies or copies == 0:
                fail(f"traced run '{name}' {rec['Phase']}: {h2d} H2D copy "
                     f"records, the counters report {copies}")
            if kernels != launches:
                fail(f"traced run '{name}' {rec['Phase']}: {kernels} "
                     f"fingerprint kernel records, {launches} launches")
            share, kinds = busy_share(events, rec["ElapsedUSecLast"])
            rate = rec["TpuHbmMiBPerSec"]
            print(f"  {name} {rec['Phase']}: device busy {share:.2%} of "
                  f"the phase's {rec['ElapsedUSecLast']} us (idle "
                  f"{1 - share:.2%}); device us by kind "
                  f"{ {k: round(v, 1) for k, v in kinds.items()} }; "
                  f"{h2d} H2D records = {copies} copies (and {warmups} "
                  f"warm-up copies), {kernels} "
                  f"fingerprint records = {launches} launches; traced "
                  f"{rate} MiB/s, untraced {untraced[name]} MiB/s")
            calls = {k: round(v, 1) for k, v in runtime_totals(events).items()}
            print(f"    host us in CUDA runtime calls, both threads: {calls}")


def entry_pass(dev) -> int:
    """The flagship step of entry() on the card, at entry()'s 1 MiB zero
    block and at a random 16 MiB block: the scrambled block must equal
    numpy's xor of block and bits, and the kernel's (sum, xor) its plain
    version's and numpy's; each call launches the kernel once. Returns
    the kernel's launches in the two calls, and prints the step's device
    time at 16 MiB."""
    import numpy as np
    import torch
    from elbencho_tpu_torch.entry import entry
    from elbencho_tpu_torch.models.workloads import example_block
    from elbencho_tpu_torch.ops.verify import (fingerprint_u32,
                                               fingerprint_u32_plain)
    step, args = entry()
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    block16, bits16 = example_block(MAIN_BLOCK, dev, gen)
    block16.copy_(rand_words(MAIN_BLOCK // 4, gen, dev))
    fingerprint_u32.launches.reset()
    for label, (block, bits) in (("1 MiB, entry()", args),
                                 ("16 MiB, random block", (block16, bits16))):
        before = fingerprint_u32.launches.count
        scrambled, total, xor = step(block, bits)
        torch.cuda.synchronize()
        if fingerprint_u32.launches.count - before != 1:
            fail(f"entry() step at {label}: "
                 f"{fingerprint_u32.launches.count - before} kernel "
                 f"launches, want 1")
        want = block.cpu().numpy().view(np.uint32) \
            ^ bits.cpu().numpy().view(np.uint32)
        if scrambled.device != block.device or not np.array_equal(
                scrambled.cpu().numpy().view(np.uint32), want):
            fail(f"entry() step at {label}: scrambled block != numpy xor")
        got = [int(total) & MASK, int(xor) & MASK]
        plain = [v & MASK for v in fingerprint_u32_plain(scrambled).tolist()]
        ref = [int(want.sum(dtype=np.uint64)) & MASK,
               int(np.bitwise_xor.reduce(want))]
        if not got == plain == ref:
            fail(f"entry() step at {label}: kernel {got}, plain {plain}, "
                 f"numpy {ref}")
        print(f"  entry() step, {label}: scrambled equals numpy's xor; "
              f"(sum, xor) = ({got[0]:#010x}, {got[1]:#010x}) equal to the "
              f"plain version and numpy; 1 launch")
    launches = fingerprint_u32.launches.count
    ms, _ = cuda_ms(lambda i=0: step(block16, bits16), 50)
    print(f"  entry() step at 16 MiB: {ms:.4f} ms per call on the device "
          f"(xor + fingerprint kernel)")
    return launches


#: the slice pass: docs/pod-slice.md's documented command (-t 4 -s 4G
#: -b 16M) on the main path's file, one stripe of 16 MiB per device
SLICE_STRIPES = MAIN_SIZE // MAIN_BLOCK
SLICE_SPECS = ("alltoall", "host", "chip", "replicate")


def slice_pass(work: str) -> int:
    """--gpuslice through the CLI on the main path's 4 GiB file, mesh of
    --gpuids 0 (one device): --redistspec alltoall and replicate, each
    through the fused ring (--gpustream on) and the preadv loop (off).
    Each run must ingest and redistribute every byte once (TpuHbmBytes =
    ShardIngestMiB = IciRedistMiB = 4 GiB), in 256 stripes, with one
    fingerprint launch per stripe (one device, one part each) and one
    for the runner's warm-up; the
    stripe fingerprints are held against the host's by the phase itself.
    Prints the phase's MiB/s, the redistribution's time per stripe (from
    dispatch to materialised, as IciRedistUSec counts it: a wait for the
    stripe's host->device copy included) and best rate beside the bound
    of a same-card copy of the stripe (each byte read and written once at
    the card's memory rate). Returns the
    kernel's launches in the four runs."""
    path = os.path.join(work, "smoke.bin")
    bound_us = 2 * MAIN_BLOCK / HBM_BYTES_PER_SEC * 1e6
    bound_gbit = MAIN_BLOCK * 8 / (bound_us * 1e3)
    launches = 0
    for spec in ("alltoall", "replicate"):
        for stream in ("on", "off"):
            name = f"--gpuslice --redistspec {spec} --gpustream {stream}"
            recs, n = run_pass(name, [
                "--gpuslice", "-t", "4", "-s", f"{MAIN_SIZE >> 20}M", "-b",
                "16M", "--gpuids", "0", "--redistspec", spec, "--gpustream",
                stream, path], os.path.join(work, "slice.json"),
                ["TPUSLICE"])
            rec = recs[0]
            expect(name, rec, TpuHbmBytes=MAIN_SIZE,
                   ShardIngestMiB=MAIN_SIZE >> 20,
                   IciRedistMiB=MAIN_SIZE >> 20, EntriesLast=SLICE_STRIPES,
                   BytesLast=MAIN_SIZE, ops=SLICE_STRIPES)
            if n != SLICE_STRIPES + 1:
                fail(f"pass '{name}': {n} fingerprint launches, want "
                     f"{SLICE_STRIPES + 1} (one per stripe, and the "
                     f"runner's warm-up)")
            launches += n
            print(f"  {name}: {rec['MiBPerSecLast']} MiB/s, redistribution "
                  f"{rec['IciRedistUSec'] / SLICE_STRIPES:.1f} us/stripe "
                  f"from dispatch (copy bound {bound_us:.1f} us), best "
                  f"{rec['IciGbpsHwm']} Gbit/s (bound {bound_gbit:,.0f} "
                  f"Gbit/s: 2 x 16 MiB at "
                  f"{HBM_BYTES_PER_SEC / 1e12:.2f} TB/s); {n} launches")
    return launches


def ready(shard):
    """(shard, an event after the work queued so far on its device's
    current stream): SliceRunner's streams wait for it, as they wait for a
    feeder's copy."""
    import torch
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(shard.device))
    return shard, event


def mesh_name(devices) -> str:
    """"8 slots of cuda:0" for repeated devices, "4 devices" for distinct
    ones."""
    if len(devices) > 1 and len(set(devices)) == 1:
        return f"{len(devices)} slots of {devices[0]}"
    return f"{len(devices)} device(s)"


def slice_runner_pass(dev) -> None:
    """SliceRunner over 4 and 8 mesh slots on the one card (check_slice_
    runner). Launches here compare and do not count in the kernel line."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    for n in (4, 8):
        check_slice_runner([dev] * n, gen)


def check_slice_runner(devices, gen) -> None:
    """SliceRunner over a mesh of ``devices`` (slots of one device or
    distinct devices), 16 MiB shards, every --redistspec: each device's
    buffer must lie on its device and equal the plain version's (torch
    indexing of the stripe), the folded fingerprint the host's, with one
    launch per device part; a stripe with one flipped word must raise
    SliceFingerprintError."""
    import numpy as np
    import torch
    from elbencho_tpu_torch.ops.verify import fingerprint_u32
    from elbencho_tpu_torch.parallel.mesh import make_ingest_mesh
    from elbencho_tpu_torch.parallel.slice_phase import (
        SliceFingerprintError, SliceRunner, host_fingerprint, target_layout)
    words, n = MAIN_BLOCK // 4, len(devices)
    mesh = make_ingest_mesh(devices)
    hosts, chips = mesh.shape
    name = f"SliceRunner {hosts}x{chips} over {mesh_name(devices)}"
    stripe = rand_words(n * words, gen, devices[0]).reshape(n, words)
    want = host_fingerprint(stripe.cpu().numpy().view(np.uint32))
    for spec in SLICE_SPECS:
        runner = SliceRunner(mesh, spec, words)
        runner.warmup()
        shards = {d: ready(stripe[d].to(devices[d], copy=True))
                  for d in range(n)}
        before = fingerprint_u32.launches.count
        handle = runner.launch(runner.assemble(shards))
        got_sum, got_xor, usec = runner.complete(handle)
        launches = fingerprint_u32.launches.count - before
        layout = target_layout(spec, hosts, chips, words)
        for d, (rows, (lo, hi), _part) in enumerate(layout):
            out = handle["out"][d]
            if out.device != devices[d] or not torch.equal(
                    out.to(stripe.device), stripe[rows, lo:hi]):
                fail(f"{name} {spec}: device {d}'s buffer != the plain "
                     f"version")
        if (got_sum, got_xor) != want or launches != n:
            fail(f"{name} {spec}: fingerprint ({got_sum:#x}, "
                 f"{got_xor:#x}) vs host {want}, {launches} launches "
                 f"(want {n})")
        runner.verify(got_sum, got_xor, *want, 0)
        shards[n - 1][0][words // 3] ^= 1 << 7
        shards[n - 1] = ready(shards[n - 1][0])
        bad = runner.complete(runner.launch(runner.assemble(shards)))
        try:
            runner.verify(bad[0], bad[1], *want, 1)
            fail(f"{name} {spec}: a flipped word was not refused")
        except SliceFingerprintError:
            pass
        gbit = n * MAIN_BLOCK * 8 / (usec * 1e3)
        print(f"  {name}, {spec}: every device buffer equals the plain "
              f"version, fingerprint equals the host's, {launches} "
              f"launches, flipped word refused; redistribution {usec} us "
              f"({gbit:,.1f} Gbit/s) for {n} x 16 MiB")
        del runner, handle


def check_collective_step(pattern: str, devices, gen) -> str:
    """One step of a collective pattern over ``devices`` on random input
    against its plain version (per device for ici); returns the route."""
    import torch
    from elbencho_tpu_torch.workers.gpubench import (CollectiveBench,
                                                     collective_plain)
    bench = CollectiveBench(pattern, devices, MAIN_BLOCK)
    bench.arrays = [rand_words(MAIN_BLOCK // 4, gen, d) for d in devices]
    got = bench.compute()
    want = collective_plain(pattern, bench.arrays)
    same = all(g.device == w.device and torch.equal(g, w)
               for g, w in zip(got, want)) \
        if pattern == "ici" else got == want
    if not same:
        fail(f"CollectiveBench {pattern} over {mesh_name(devices)}: one "
             f"step differs from the plain version")
    return bench.route


COLLECTIVE_SIZE = 1 << 30      # -s 1G of the collective patterns


def collective_pass(work: str, dev) -> None:
    """Each collective --gpubench pattern through the CLI at -s 1G -b 16M
    on --gpuids 0 (n = 1: 64 steps of 16 MiB): bytes and ops, the op
    latency's p50/p99; then one step on random input against the plain
    version (torch ops over the per-device tensors); then ici's and
    alltoall's copies over 8 slots of the card against the plain
    version (NCCL takes distinct devices, so the reductions run at n = 1
    only)."""
    import torch
    from elbencho_tpu_torch.stats.latency_histogram import LatencyHistogram
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    steps = COLLECTIVE_SIZE // MAIN_BLOCK
    for pattern in ("ici", "allgather", "reducescatter", "alltoall",
                    "psum"):
        name = f"--gpubench {pattern}"
        rec = bench_run(name, ["--gpubench", "--gpubenchpat", pattern,
                               "--gpuids", "0", "-s",
                               f"{COLLECTIVE_SIZE >> 20}M", "-b", "16M"],
                        os.path.join(work, "collective.json"))
        expect(name, rec, BytesLast=COLLECTIVE_SIZE,
               TpuHbmBytes=COLLECTIVE_SIZE, ops=steps)
        route = check_collective_step(pattern, [dev], gen)
        histo = LatencyHistogram.from_dict(rec["IOLatHisto"])
        print(f"  {name:<26} route {route}: {rec['TpuHbmMiBPerSec']} "
              f"MiB/s, op latency p50 {histo.percentile(50):.1f} us, p99 "
              f"{histo.percentile(99):.1f} us ({steps} steps of 16 MiB); one "
              f"step equals the plain version; {rec['secs']:.1f} s")
    for pattern in ("ici", "alltoall"):
        route = check_collective_step(pattern, [dev] * 8, gen)
        print(f"  CollectiveBench {pattern} over 8 slots of {dev}, route "
              f"{route}: one step equals the plain version")


def corruption_run(work: str) -> None:
    path = os.path.join(work, "smoke.bin")
    rc, _ = run_cli(["-w", "-t", "2", "-b", "16M", "-s", f"{MAIN_SIZE >> 20}M",
                     "--iodepth", "4", "--verify", "7", "--gpuids", "0",
                     path],
                    os.path.join(work, "rewrite.json"))
    if rc != 0:
        fail("rewriting the verify pattern failed")
    with open(path, "r+b") as f:
        f.seek(MAIN_SIZE // 4 + 123457)
        byte = f.read(1)
        f.seek(MAIN_SIZE // 4 + 123457)
        f.write(bytes([byte[0] ^ 0x40]))
    from elbencho_tpu_torch.ops.verify import fingerprint_u32
    for mode, flags in (("staged", []),
                        ("fused ring, --gpudirect",
                         ["--gpudirect", "--gpustream", "on"])):
        launches_before = fingerprint_u32.launches.count
        # the read must fail for the integrity check's reason alone, not
        # for a launch, registration or setup error: keep its stderr
        err = _Tee()
        with contextlib.redirect_stderr(err):
            rc, _ = run_cli(["-r", "-t", "2", "-b", "16M", "--iodepth", "4",
                             "--verify", "7", "--gpuids", "0", "--gpuverify",
                             *flags, path],
                            os.path.join(work, "corrupt.json"))
        launches = fingerprint_u32.launches.count - launches_before
        if rc == 0:
            fail(f"the --gpuverify read ({mode}) of a corrupted file "
                 f"succeeded")
        if INTEGRITY_ERROR not in err.text.getvalue():
            fail(f"the --gpuverify read ({mode}) of a corrupted file failed "
                 f"(rc {rc}), but not with '{INTEGRITY_ERROR}'")
        if launches == 0:
            fail(f"the corruption run ({mode}) failed without launching the "
                 f"fingerprint kernel")
        print(f"corruption run ({mode}): --gpuverify read of a file with one "
              f"flipped byte failed as it must (rc {rc}, '{INTEGRITY_ERROR}' "
              f"after {launches} fingerprint launches)")


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA device")
    sys.path.insert(0, REPO)
    try:
        import elbencho_tpu_torch  # noqa: F401
    except ImportError as err:
        fail(f"the elbencho_tpu_torch package is not beside chip_smoke.py "
             f"({err})")
    t_start = time.monotonic()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(dev)}, "
          f"{torch.cuda.device_count()} device(s)")
    kernel = kernel_phase(dev)
    check_registered_slot(dev)
    from elbencho_tpu_torch.ops.cuda_build import build_reports
    from elbencho_tpu_torch.utils.native import get_native_engine
    engine = get_native_engine()
    if engine is None:
        fail("the native I/O engine needs g++, and there is none")
    secs, report = build_reports["ioengine"]
    built = "found built in _build/" if report == "cached" \
        else f"built with g++ in {secs:.1f} s"
    print(f"native I/O engine: {engine.version()}, {built}; stream "
          f"backend {engine.stream_backend_name()}")

    work = os.path.join(REPO, "_smoke_data")
    os.makedirs(work, exist_ok=True)
    need = DATASET_FILES * MAIN_BLOCK + (1 << 30)
    free = shutil.disk_usage(work).free
    if free < need:
        fail(f"{work} has {free >> 20} MiB free; the dataset pass needs "
             f"{need >> 20} MiB (its 8 GiB plus 1 GiB of headroom)")
    try:
        untraced: "dict[str, float]" = {}
        launches = main_path(work, untraced)
        headline_pass(work, engine.stream_backend_name(), untraced)
        gpubatch_pass(work)
        bench = gpubench_pass(work)
        untraced["--gpubench h2d"] = \
            bench["h2d", False, MAIN_BLOCK]["TpuHbmMiBPerSec"]
        gpuprofile_pass(work, untraced)
        launches += slice_pass(work)
        slice_runner_pass(dev)
        collective_pass(work, dev)
        corruption_run(work)
        os.unlink(os.path.join(work, "smoke.bin"))
        launches += striped_pass(work)
        launches += dataset_pass(work)
        launches += losf_pass(work)
        launches += entry_pass(dev)
        kernel["launches"] = launches
    finally:
        shutil.rmtree(work, ignore_errors=True)

    total = time.monotonic() - t_start
    print(f"total {total:.1f} s")
    if total > TIME_LIMIT_S:
        fail(f"the run took {total:.1f} s, over its {TIME_LIMIT_S} s limit")
    for line in smi.stdout.strip().splitlines():
        print(line.strip())
    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    print(json.dumps({"kernels": [{k: kernel[k] for k in order}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
