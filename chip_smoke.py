#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (elbencho_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

It needs one CUDA device and the repository beside it, and exits nonzero
without printing a result otherwise. In order it:

1. prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and the build times of the kernel and of the native I/O
   engine (csrc/ioengine.cpp, g++); as the control of the AIO checks,
   makes raw io_setup/io_destroy pairs from several threads under no
   lock and prints how many io_setup calls the kernel refuses (the race
   the checks guard against; 0 there shows nothing); opens and closes
   the engine's stream ring from several threads at once, as a phase's
   workers do, and fails if an open is refused (printing beside it how
   many opens the kernel refuses when the wrapper does not serialize
   them);
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
   files run (8 threads x 16 dirs x 256 files of 4 KiB through all six
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
10. run control, after 9 and before 7, on the main path's file: -r
   --infloop --timelimit 5, staged and --gpudirect, through the fused
   ring and the Python loop, plain and with --verify 7 --gpuverify (exit
   0, the overrun of the limit measured and bounded, the file looped,
   the device bytes equal to the storage bytes, one kernel launch per
   block copied); -w -r -i 2 --verify 7 --gpuverify at -s 1g (two WRITE
   and two READ records, twice one pass's launches); --gpuslice -t 4 cut
   by --timelimit 1 (whole stripes, exit 0), then a slice run without a
   limit; and two child processes: one reading with --infloop --gpudirect
   --gpuverify, given SIGINT after 3 s (exit 3, its READ record, no CUDA
   error), one given two SIGINTs in a --phasedelay (killed by SIGINT);
11. runs the flagship step of entry() (xor scramble + the fingerprint
   kernel) at 1 MiB and 16 MiB: the scrambled block must equal numpy's
   xor, the (sum, xor) the plain version's and numpy's, one launch per
   call; its launches count in the kernel line;
12. a phase's result output, after 10 and before 7, on the main path's
   file at -t 2 -b 16M --iodepth 4 with --lat --lathisto --latpercent
   --latpercent9s 3 --allelapsed --cpu, a --label holding a comma and
   the three result files, all runs appending to one CSV: -r through the
   fused ring and the Python loop, staged and --gpudirect, a --gpudirect
   --gpuverify read of 1 GiB, --gpubench h2d -s 4g and --gpuslice -t 4;
   checks the result file against the printed table, each CSV row's
   fixed columns against its JSON record, the bytes each run was given,
   one IO latency per op, the printed percentiles against the JSON
   histogram, a CPU use above 0 where /proc/stat advances (0 where it is
   frozen) and one kernel launch per verified block, and prints each run's p50, p99
   and p99.9 latency, CPU use, rate and wall time;
13. live statistics, after 12 and before 7, on the main path's file at
   -t 2 -b 16M --iodepth 4 with --liveint 250 --live1n --cpu, the live
   CSV and JSON (--livejsonex) and a --label holding a comma, the console
   captured: -r --infloop --timelimit 4, staged through the fused ring,
   --gpudirect through the ring and the Python loop, and the --gpudirect
   ring again with --nolive; a --gpudirect --gpuverify read of 1 GiB;
   --gpubench h2d -s 4g; --gpuslice -t 4; checks that the CSV, the JSON
   and the console hold equally many rows (none on the console under
   --nolive), one per 250 ms of the phase within one, that Seconds and
   Bytes never go back and the last row's Bytes is at most the record's,
   that each row's per-worker counters add up to its totals, that the
   4 s reads' Bytes advance in at least 3 rows, the time limit's
   overrun, the live CPU column (above 0 where /proc/stat advances, 0
   where it is frozen), one kernel launch per verified block, one CSV
   header and 7 columns a row; prints each run's rows, the least and
   most rate between two rows and the phase's MiB/s beside the --nolive
   twin's;
14. data-plane fault tolerance (fault_pass), after 13 and before 7, on
   the main path's file at -t 2 -b 16M --iodepth 4 with
   ELBENCHO_TPU_TESTING=1 for the pass alone: --ioretries 3 with every
   5th storage op short (the ring through the engine's
   ELBENCHO_TPU_IO_FAULT, whose "first" schedule faults no retry, the
   Python loop through a patched os.preadv),
   staged and --gpudirect, each beside a clean read, a short --verify
   read and a short 1 GiB --gpudirect --gpuverify read (one launch per
   block); hang:13 with --iotimeout 1; eio:7, which must fail unless the
   file is on a network file system; a simulated lost GPU under
   --gpufallback host (a 1 GiB --gpuverify read, every block verified on
   the card or the host, and a --verify write that a fresh read
   verifies) and under the default, which must fail naming
   --gpufallback; then a real sticky CUDA error (chip_sticky_fault.cu's
   store through the null pointer) in a child process writing under
   --gpufallback host, which must exit 0 with TpuChipFailovers 1 (or,
   if the process cannot outlive it, fail with a clear error, printed
   as a finding), and a fresh read here that verifies its file; prints
   each run's rate beside the clean one, retries, timeouts, the time
   from the loss to the first host-staged copy and the rate after it;
15. mixed and rate-shaped traffic (rwmix_pass), after 14 and before 7, on
   the main path's file at -t 2 -b 16M --iodepth 4: (a) -w --rwmixpct 30
   --verify 7 --gpuverify through the fused ring and the Python loop,
   staged and --gpudirect, each with the rule's 116 reads and 140 writes,
   116 kernel launches and a whole-file --gpuverify read after it; (b)
   -w --rwmixthr 1 (the reader's 2 GiB booked as rwmix reads, the
   writer's as BytesLast, both in TpuHbmBytes), and with --rwmixthrpct 50
   through the Python loop; (c) --limitread/--limitwrite 512M with and
   without a device (at least 3 s, at most 4/3 of the limits' rate), and
   --limitread 256M cut by --timelimit 3 within the run-control bound;
   (d) --blockvarpct 50 at 1 GiB without a device (every block's first
   half new, the second halves repeating) and with one (the bytes of the
   write without it); prints each run's loop, MiB/s, rwmix read MiB/s
   and the D2H copies served by the speculation and issued fresh;
16. the engine's last per-op features (blockmod_pass), after 15 and
   before 7, at -t 2 -b 16M --iodepth 4 on a 1 GiB file: (a) -w --verify
   7 --verifydirect, staged and --gpudirect (the ring's NOTE names the
   read-back, the Python loop serves every op, 64 D2H copies), each
   followed by a --gpuverify read (64 launches); (b) -r --gpuverify
   --opslog --opsloglock (64 whole JSON read records of ranks 0 and 1
   covering the file once, 64 launches), and --gpustream on --opslog,
   which must fail naming the blocker; (c) -w -r --flock range and full
   with --gpudirect; (d) without a device at --iodepth 1, --opslog (the
   engine writes the records), --flock range and --readinline, each
   through the engine's block loop with the feature's argument; prints
   each run's loop and MiB/s beside its twin's (the same run without
   the feature, through the ring where it is eligible) and the pass's
   wall time, which must stay within BLOCKMOD_LIMIT_S (90 s);
17. the engine's per-file loop and the custom trees (tree_pass), after
   the small-files pass of 8 and before 11: (a) the small-files run
   without a device (-t 8 -n 16 -N 64 -s 4K -b 4K --verify 7 through
   all six phases), which the engine's per-file loop must serve, its
   entries/s printed beside the device run's; (b) a tree of 64 files
   (two shared files of 512 and 528 MiB, 62 small ones from 0 bytes to
   16 MiB, most not a multiple of 4 KiB) scanned with --treescan and
   checked, then -w -r --verify 7 --gpuverify --gpuids 0 -t 2 -b 16M
   --iodepth 4 --treefile, staged and --gpudirect, --treeroundrob, and
   a --treerand read, each with the tree's bytes, the sublists'
   entries, one launch per block read and, exactly, the fused ring's
   ops of the ranges at least two ring-fills long, then -F; prints
   each run's loop and MiB/s and the pass's wall time, which must stay
   within TREE_LIMIT_S (90 s);
18. memory-mapped I/O (mmap_pass), after 17 and before 11, at -t 2 -b
   16M --iodepth 4 on a 2 GiB file: (a) -w -r --mmap --verify 7
   --gpuverify --gpuids 0, staged and --gpudirect, through the Python
   memcpy loop (no fused-ring op, one launch per block read), each
   beside its --gpustream off pread twin; (b) the same without a
   device, through the engine's mmap loop (a spy on run_mmap_loop),
   beside its block-loop twin; (c) dir mode -n 1 -N 64 -s 16M --mmap
   --madv seq,willneed --fadv seq with --gpuverify; (d) --madv hugepage
   and nohugepage --gpudirect reads, printing the staging slabs'
   hugepage_backed and checking them pinned after cudaHostRegister; (e)
   the --gpustream on --mmap refusal; prints each run's loop and MiB/s
   beside its twin's and the pass's wall time, which must stay within
   MMAP_LIMIT_S (90 s); and, beside the ring setup check of 1, 4
   threads x 250 calls of the engine's block loop on kernel AIO, none
   of which may be refused;
19. direct I/O and the access patterns (access_pass), after 18 and
   before 11, at -t 2 -b 16M --iodepth 4 on a 2 GiB file: an O_DIRECT
   probe of the work directory (open, F_GETFL, an aligned and a
   misaligned preadv, printed; where no directory opens with O_DIRECT a
   --direct phase must fail with the JAX package's text and the runs go
   on without --direct); the main path's read with --direct through the
   fused ring, staged and --gpudirect, each beside its buffered twin,
   the ring's fds checked for O_DIRECT, and a --direct --gpuverify read;
   --verify 7 --gpuverify reads under --rand --randamount 512M for each
   --randalgo, --backward, --strided and --shufflewindow 256M (one
   launch per block read; the last three read every block once); a
   --rand --norandalign read, and its --gpuverify twin, which must fail
   on an unaligned block as the JAX package's does; the shuffled read
   beside its sequential twin;
   -w -r over f{1..4} against --nopathexp; --nofdsharing (one open per
   worker); the --mmap --direct and --shufflewindow --rand refusals;
   prints each run's MiB/s and the pass's wall time, which must stay
   within ACCESS_LIMIT_S (90 s);
20. the file-lifecycle flags (lifecycle_pass), after 19 and before 11,
   at -t 2 -b 16M --iodepth 4: a posix_fallocate probe of the work
   directory (printed; where it fails, a --preallocfile write must fail
   with its error and the runs go on without the flag); a dir-mode
   write of 2 GiB (-n 1 -N 16 -s 64M) with --trunc --preallocfile
   --statinline --sync --verify 7, staged and --gpudirect, each followed
   by a --statinline --gpuverify read (128 launches each), with the
   SYNC phases, fstat, posix_fallocate and O_TRUNC calls counted and the
   file sizes checked; a file-mode --trunctosize write over a longer
   file, which must end exactly -s long; RMFILES of missing files,
   failing without --nodelerr and passing with it; --gpuprofile reads
   at --log 1 (the trace line printed) and --log 0 (not); and -r --sync
   --dropcaches in a child process whose open() of
   /proc/sys/vm/drop_caches is patched, so that nothing is written
   there; prints each run's MiB/s, the SYNC phases' elapsed times and
   the pass's wall time, which must stay within LIFECYCLE_LIMIT_S (90 s);
21. placing the work on the devices and cores of the host
   (placement_pass), after 20 and before 11: dryrun_multigpu(1) over the
   card and dryrun_multigpu(4) over four slots of it (the ingest step at
   tiny, 1 MiB and 16 MiB shards, with a fresh process that must find
   the built kernel in _build/; the five collectives; the measured
   --gpuslice capture at -s 1G -b 16M and its MULTIGPU_MEASURED line),
   launches counted exactly; then on a 2 GiB file at -r -t 4 -b 16M
   --iodepth 4 --gpuids 0: --cores with every core of the process's
   affinity under --gpudirect (each worker's thread on cores[rank %
   len]), and --zones 0 staged and --gpudirect, held to what a probe of
   the machine's NUMA sysfs and memory-policy calls finds (printed, with
   the case that held: MPOL_BIND on node 0 for each worker's thread and
   every slot where the calls read back, the JAX package's "not found"
   line where node 0 is missing), the --gpudirect slots page-locked;
   prints each read's MiB/s beside its twin's without the flag and the
   pass's wall time, which must stay within PLACEMENT_LIMIT_S (90 s);
22. prints the kernel line {"kernels": [...]} and, last, the result line
   {"ok": true, "device": {...}}.

Any failed phase exits nonzero. The whole run, kernel build included, must
end within TIME_LIMIT_S (1200 s) and fails past it; the passes are sized to
take about half of that, so that later passes fit beside them. The data
lives in _smoke_data/ of the checkout (listed in .gitignore) and is removed
at the end.
"""

from __future__ import annotations

import collections
import contextlib
import errno
import io
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
# the CLI runs write only the result files they name, inside the checkout:
# no default result files under /var/tmp
os.environ["ELBENCHO_TPU_NO_DEFAULT_RESFILES"] = "1"
MAIN_BLOCK = 16 << 20          # bytes per block on the main path (-b 16M)
MAIN_SIZE = 4 << 30            # -s 4g
MAIN_BLOCKS = MAIN_SIZE // MAIN_BLOCK
HBM_BYTES_PER_SEC = 3.35e12    # H100 SXM device memory, NVIDIA data sheet
DATASET_FILES = 8 * 64          # -t 8 -n 1 -N 64 of 16 MiB: 8 GiB
LOSF_PER_DIR = 256             # -N: files per directory of the LOSF pass
LOSF_FILES = 8 * 16 * LOSF_PER_DIR  # -t 8 -n 16 of 4 KiB
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


RACE_THREADS = 4               # threads of the ring setup check
RACE_ROUNDS = 250              # stream opens and closes per thread


def ring_setup_race(engine, path: str, serialized: bool) -> int:
    """RACE_THREADS threads each open and close a stream ring over two
    slots of their own RACE_ROUNDS times, at once; returns the opens
    refused. Not `serialized`, the wrapper's lock around the AIO-context
    calls is lifted for the run."""
    from elbencho_tpu_torch.utils import native
    from elbencho_tpu_torch.utils.staging_pool import StagingPool
    fd = os.open(path, os.O_RDONLY)
    pools = [StagingPool(2, 4096) for _ in range(RACE_THREADS)]
    refused = []
    lock = native._aio_ctx_lock
    if not serialized:
        native._aio_ctx_lock = contextlib.nullcontext()

    def opener(pool):
        for _ in range(RACE_ROUNDS):
            try:
                stream = engine.open_stream([fd], pool.slot_addrs, 4096)
            except OSError as err:
                refused.append(err)
                continue
            if stream.close() != 0:
                refused.append("drain")
    threads = [threading.Thread(target=opener, args=(pool,))
               for pool in pools]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        native._aio_ctx_lock = lock
        os.close(fd)
        for pool in pools:
            pool.close()
    if "drain" in refused:
        fail("a stream ring of the setup check did not drain at close")
    return len(refused)


def check_ring_setup(engine, work: str) -> None:
    """A phase's workers open and close their stream rings at the same
    time (one per file in dir mode and in a custom tree). On a kernel
    whose io_destroy unmaps a context's ring page before it retires the
    context (gVisor, which reports Linux 4.4.0), another thread's
    io_setup can map that page and fail with EINVAL; the wrapper and the
    engine both serialize those calls. Fails on a refused open; prints
    how many are refused without the wrapper's lock (the engine's own
    lock still held)."""
    path = os.path.join(work, "ring_setup.bin")
    with open(path, "wb") as f:
        f.write(bytes(8192))
    t0 = time.monotonic()
    bare = ring_setup_race(engine, path, serialized=False)
    locked = ring_setup_race(engine, path, serialized=True)
    os.unlink(path)
    print(f"ring setup check on Linux {os.uname().release}: "
          f"{RACE_THREADS} threads x {RACE_ROUNDS} stream opens and closes "
          f"each, backend {engine.stream_backend_name()}: {bare} refused "
          f"without the wrapper's lock (the engine's held), {locked} with "
          f"both "
          f"({time.monotonic() - t0:.2f} s)")
    if locked:
        fail(f"{locked} stream ring opens refused while the wrapper "
             f"serialized the AIO-context calls")


RAW_PAIRS = 2000                # raw io_setup/io_destroy pairs per thread
RAW_LIMIT_S = 20.0              # the control stops early past this
#: the AIO-context syscall numbers (io_setup, io_destroy) by machine
AIO_SYSCALLS = {"x86_64": (206, 207), "aarch64": (0, 1)}


def aio_race_control() -> "int | None":
    """The control of the two AIO checks: RACE_THREADS threads each make
    RAW_PAIRS io_setup/io_destroy syscalls through ctypes (which releases
    the GIL around them) under no lock at all, as the engine did before
    its lock, stopping early past RAW_LIMIT_S (a kernel whose io_destroy
    waits for a grace period takes milliseconds a pair). Returns the io_setup calls refused (None where the syscall
    numbers are unknown): more than 0 shows that the race is live on this
    kernel, so that the locked checks' 0 is the locks' doing; 0 shows
    nothing. Fails if an io_destroy is refused."""
    import ctypes
    nrs = AIO_SYSCALLS.get(os.uname().machine)
    if nrs is None:
        print(f"AIO race control: no syscall numbers for "
              f"{os.uname().machine}; not run")
        return None
    libc = ctypes.CDLL(None, use_errno=True)
    refused, destroy_failed, made = [], [], []
    t0 = time.monotonic()

    def pairs():
        n = 0
        while n < RAW_PAIRS and time.monotonic() - t0 <= RAW_LIMIT_S:
            n += 1
            ctx = ctypes.c_ulong(0)
            if libc.syscall(ctypes.c_long(nrs[0]), ctypes.c_long(4),
                            ctypes.byref(ctx)) != 0:
                refused.append(ctypes.get_errno())
                continue
            if libc.syscall(ctypes.c_long(nrs[1]), ctx) != 0:
                destroy_failed.append(ctypes.get_errno())
        made.append(n)
    threads = [threading.Thread(target=pairs) for _ in range(RACE_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    errnos = ", ".join(f"{errno.errorcode.get(e, e)} x {n}" for e, n in
                       sorted(collections.Counter(refused).items()))
    print(f"AIO race control on Linux {os.uname().release}: "
          f"{RACE_THREADS} threads x {RAW_PAIRS} raw io_setup/io_destroy "
          f"pairs under no lock ({sum(made)} made): {len(refused)} "
          f"io_setup refused"
          f"{f' ({errnos})' if errnos else ''} "
          f"({time.monotonic() - t0:.2f} s); "
          + ("the race is live here" if refused else
             "the race did not show, so the locked checks' 0 proves "
             "nothing on this run"))
    if destroy_failed:
        fail(f"{len(destroy_failed)} raw io_destroy calls refused "
             f"({destroy_failed[:1]})")
    return len(refused)


BLOCK_LOOP_BLOCKS = 4           # 4 KiB blocks per block-loop call


def check_block_loop_race(engine, work: str) -> None:
    """Workers without a device run the engine's block loop at once, and
    on kernel AIO each call sets up and destroys its own context: the
    race of check_ring_setup inside one engine call, which the engine's
    lock serializes. RACE_THREADS threads each make RACE_ROUNDS block-loop
    calls (--ioengine aio, --iodepth 4, alternately writing and reading
    BLOCK_LOOP_BLOCKS blocks of a file of their own under --verify 7);
    fails on any refused call and on wrong accounting."""
    import ctypes
    import types

    import numpy as np
    from elbencho_tpu_torch.stats.latency_histogram import LatencyHistogram
    from elbencho_tpu_torch.utils.staging_pool import StagingPool
    from elbencho_tpu_torch.workers.base import LiveOps
    block = 4096
    offsets = np.arange(BLOCK_LOOP_BLOCKS, dtype=np.uint64) * block
    lengths = np.full(BLOCK_LOOP_BLOCKS, block, dtype=np.uint64)
    refused, others = [], []

    def caller(rank, acct):
        path = os.path.join(work, f"block_loop{rank}.bin")
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        pool = StagingPool(1, block * BLOCK_LOOP_BLOCKS)
        try:
            for i in range(RACE_ROUNDS):
                try:
                    engine.run_block_loop(
                        [fd], None, offsets, lengths, i % 2 == 0,
                        pool.slot_addrs[0], 4, acct, ctypes.c_int(0),
                        engine="aio", verify_salt=7)
                except OSError as err:
                    refused.append(err)
                except Exception as err:  # noqa: BLE001 - reported below
                    others.append(err)
        finally:
            os.close(fd)
            pool.close()
            os.unlink(path)

    accts = [types.SimpleNamespace(
        rank=r, live_ops=LiveOps(), live_ops_rwmix_read=LiveOps(),
        iops_latency_histo=LatencyHistogram(),
        iops_latency_histo_rwmix=LatencyHistogram(),
        _num_iops_submitted=0,
        create_stonewall_stats_if_triggered=lambda: None)
        for r in range(RACE_THREADS)]
    threads = [threading.Thread(target=caller, args=(r, a))
               for r, a in enumerate(accts)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    print(f"AIO block-loop check: {RACE_THREADS} threads x {RACE_ROUNDS} "
          f"engine block-loop calls (--ioengine aio, --iodepth 4, "
          f"{BLOCK_LOOP_BLOCKS} blocks each): {len(refused)} refused "
          f"({time.monotonic() - t0:.2f} s)")
    if refused or others:
        fail(f"{len(refused)} engine block-loop calls refused on kernel AIO "
             f"({refused[:1]}), {len(others)} failed otherwise "
             f"({others[:1]})")
    for acct in accts:
        if acct.live_ops.num_iops_done != RACE_ROUNDS * BLOCK_LOOP_BLOCKS:
            fail(f"the AIO block-loop check booked "
                 f"{acct.live_ops.num_iops_done} ops for a thread, want "
                 f"{RACE_ROUNDS * BLOCK_LOOP_BLOCKS}")


def run_cli(args: "list[str]", json_path: str,
            live: bool = False) -> "tuple[int, list[dict]]":
    """One in-process CLI run; its console live statistics are off unless
    `live`."""
    from elbencho_tpu_torch.cli import main as cli_main
    if os.path.exists(json_path):
        os.unlink(json_path)
    rc = cli_main(args + ([] if live else ["--nolive"])
                  + ["--jsonfile", json_path])
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
             want_phases: "list[str]", live: bool = False,
             on_device: bool = True) -> "tuple[list[dict], int]":
    """One CLI run with the kernel's launch count zeroed just before it and
    read just after it; fails unless it exits 0 with `want_phases` on a
    CUDA device (or, not `on_device`, on none). Returns (records,
    fingerprint launches)."""
    from elbencho_tpu_torch.ops.verify import fingerprint_u32
    fingerprint_u32.launches.reset()
    t0 = time.monotonic()
    rc, recs = run_cli(args, json_path, live)
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
        if on_device and "cuda" not in rec["Device"]:
            fail(f"pass '{name}' {rec['Phase']} did not run on a CUDA device")
        if not on_device and (rec["Device"] or rec["TpuHbmBytes"]):
            fail(f"pass '{name}' {rec['Phase']} ran on {rec['Device']}")
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


def losf_pass(work: str) -> "tuple[int, dict]":
    """Lots of small files through all six phases; returns the READ's
    fingerprint launches and each phase's entries/s."""
    bench = os.path.join(work, "losf")
    os.makedirs(bench)
    name = "lots of small files, dir mode"
    recs, launches = run_pass(
        name, ["-d", "-w", "--stat", "-r", "-F", "-D", "-t", "8", "-n", "16",
               "-N", str(LOSF_PER_DIR), "-s", "4K", "-b", "4K", "--verify",
               "7",
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
    return launches, {r["Phase"]: r["EntriesPerSecLast"] for r in recs}


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
    from elbencho_tpu_torch.workers.gpubench import CollectiveBench
    bench = CollectiveBench(pattern, devices, MAIN_BLOCK)
    bench.arrays = [rand_words(MAIN_BLOCK // 4, gen, d) for d in devices]
    if not bench.equals_plain():
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


RUN_LIMIT_S = 5               # --timelimit of the looped reads
RUN_SLACK_S = 1.0             # most a cut phase may overrun its limit
ITER_SIZE = 1 << 30           # -s 1g of the -i 2 pass
SIGNAL_AFTER_S = 3.0          # the first SIGINT, after the phase began


def runcontrol_pass(work: str) -> int:
    """Run control on the main path's file at full width (-t 2 -b 16M
    --iodepth 4 --gpuids 0). Returns the fingerprint launches.

    - -r --infloop --timelimit 5, staged and --gpudirect, through the
      fused ring and the Python loop, plain and with --verify 7
      --gpuverify: exit 0, the phase ends within RUN_SLACK_S of the limit
      (the measured overrun is printed), whole blocks, the device bytes
      equal the storage bytes, the loop asked for served every op, the
      plain reads loop the 4 GiB file, and under --gpuverify one kernel
      launch per block copied: a read still in flight when the clock
      stopped is never copied, and every copy is verified;
    - -w -r -i 2 --verify 7 --gpuverify at -s 1g: two WRITE and two READ
      records of exact bytes, twice one pass's launches;
    - -r --gpuslice -t 4 --timelimit 1: exit 0, whole stripes, one launch
      per stripe redistributed and the warm-up; then the same slice
      without a limit reads all 256 stripes;
    - a child process reading with --infloop --gpudirect --gpuverify,
      given SIGINT: exit 3, its READ record, no CUDA error; and one given
      two SIGINTs in the delay between two phases: killed by SIGINT."""
    t_start = time.monotonic()
    path = os.path.join(work, "smoke.bin")
    json_path = os.path.join(work, "runcontrol.json")
    common = ["-t", "2", "-b", "16M", "--iodepth", "4", "--gpuids", "0"]
    loops = (("staged, fused ring", ["--gpustream", "on"]),
             ("staged, Python loop", ["--gpustream", "off"]),
             ("--gpudirect, fused ring", ["--gpudirect", "--gpustream",
                                          "on"]),
             ("--gpudirect, Python loop", ["--gpudirect", "--gpustream",
                                           "off"]))
    total = 0
    for verify in ([], ["--verify", "7", "--gpuverify"]):
        for loop, flags in loops:
            name = (f"-r --infloop --timelimit {RUN_LIMIT_S}, {loop}"
                    + (" --gpuverify" if verify else ""))
            (rec,), launches = run_pass(
                name, ["-r", "--infloop", "--timelimit", str(RUN_LIMIT_S),
                       *common, *flags, *verify, path], json_path, ["READ"])
            ops = device_ops(rec)
            slack = rec["ElapsedUSecLast"] / 1e6 - RUN_LIMIT_S
            fused = "fused" in loop
            expect(name, rec, TpuHbmBytes=ops * MAIN_BLOCK,
                   BytesLast=ops * MAIN_BLOCK,
                   TpuStreamFusedOps=ops if fused else 0,
                   TpuH2dDirectOps=ops if "direct" in loop else 0)
            if not 0 <= slack <= RUN_SLACK_S:
                fail(f"pass '{name}' ended {slack:.3f} s after its limit")
            if not verify and rec["BytesLast"] <= MAIN_SIZE:
                fail(f"pass '{name}' did not loop the file")
            if launches != (ops if verify else 0):
                fail(f"pass '{name}': {launches} fingerprint launches for "
                     f"{ops} blocks copied")
            print(f"  {name}: {rec['MiBPerSecLast']} MiB/s, elapsed "
                  f"{rec['ElapsedUSecLast']} us (limit + {slack:.3f} s), "
                  f"{rec['BytesLast'] / MAIN_SIZE:.2f} passes of the file, "
                  f"{loop_taken(rec)} as asked, {launches} launches")
            total += launches

    iter_path = os.path.join(work, "iter.bin")
    name = "-w -r -i 2 --verify 7 --gpuverify, -s 1g"
    recs, launches = run_pass(
        name, ["-w", "-r", "-i", "2", "-s", f"{ITER_SIZE >> 20}M", *common,
               "--verify", "7", "--gpuverify", iter_path], json_path,
        ["WRITE", "READ", "WRITE", "READ"])
    blocks = ITER_SIZE // MAIN_BLOCK
    for rec in recs:
        expect(name, rec, BytesLast=ITER_SIZE, TpuHbmBytes=ITER_SIZE,
               ops=blocks, device_ops=blocks)
    if launches != 2 * blocks:
        fail(f"pass '{name}': {launches} launches, want {2 * blocks}")
    os.unlink(iter_path)
    total += launches

    name = "-r --gpuslice -t 4 --timelimit 1"
    recs, launches = run_pass(
        name, ["-r", "--gpuslice", "-t", "4", "-b", "16M", "--gpuids", "0",
               "--timelimit", "1", path], json_path, ["READ", "TPUSLICE"])
    rec = recs[1]
    stripes = rec["EntriesLast"]
    slack = rec["ElapsedUSecLast"] / 1e6 - 1
    expect(name, rec, TpuHbmBytes=rec["BytesLast"],
           ShardIngestMiB=rec["BytesLast"] >> 20,
           IciRedistMiB=stripes * (MAIN_BLOCK >> 20))
    if not 0 <= rec["BytesLast"] - stripes * MAIN_BLOCK <= 2 * MAIN_BLOCK \
            or rec["BytesLast"] % MAIN_BLOCK:
        fail(f"pass '{name}': {rec['BytesLast']} bytes ingested for "
             f"{stripes} stripes redistributed")
    if launches != stripes + 1 or slack > RUN_SLACK_S:
        fail(f"pass '{name}': {launches} launches for {stripes} stripes "
             f"(want one each and the warm-up), {slack:.3f} s over")
    print(f"  {name}: {rec['MiBPerSecLast']} MiB/s, {stripes} of "
          f"{SLICE_STRIPES} stripes redistributed, {rec['BytesLast']} "
          f"bytes ingested, elapsed {rec['ElapsedUSecLast']} us (limit + "
          f"{slack:.3f} s), {launches} launches")
    total += launches
    name = "--gpuslice -t 4 after the cut one"
    (rec,), launches = run_pass(
        name, ["--gpuslice", "-t", "4", "-b", "16M", "--gpuids", "0", path],
        json_path, ["TPUSLICE"])
    expect(name, rec, EntriesLast=SLICE_STRIPES, BytesLast=MAIN_SIZE,
           IciRedistMiB=MAIN_SIZE >> 20)
    if launches != SLICE_STRIPES + 1:
        fail(f"pass '{name}': {launches} launches")
    total += launches + signal_children(work)
    print(f"run control pass: {time.monotonic() - t_start:.1f} s, "
          f"{total} fingerprint launches")
    return total


OUTPUT_FLAGS = ["--lat", "--lathisto", "--latpercent", "--latpercent9s", "3",
                "--allelapsed", "--cpu"]
OUTPUT_LABEL = "smoke, output"  # a comma: the CSV escapes it to ';'
OUTPUT_VERIFY_SIZE = 1 << 30    # the --gpuverify read of the output pass


def _proc_stat_moves() -> bool:
    """Whether the host's /proc/stat "cpu" line advances over a 0.2 s
    busy loop of this process."""
    def read():
        with open("/proc/stat") as f:
            return f.readline()
    before = read()
    t0 = time.process_time()
    while time.process_time() - t0 < 0.2:
        pass
    return read() != before


def output_pass(work: str) -> int:
    """A phase's result output at full width (-t 2 -b 16M --iodepth 4
    --gpuids 0) with --lat --lathisto --latpercent --latpercent9s 3
    --allelapsed --cpu and --resfile/--csvfile/--jsonfile, every run
    appending to one CSV, on the main path's file: -r through the fused
    ring and the Python loop, staged and --gpudirect; a --gpudirect
    --gpuverify read of the file's first 1 GiB; --gpubench h2d at -s 4g;
    --gpuslice -t 4. Each run must exit 0 and:

    - write a result file whose lines are the printed table's, the rule
      line excluded;
    - append one CSV row per phase, under the one header of the port's
      36 fixed columns, whose fixed columns equal the phase's JSON
      record, ';' in place of the label's comma;
    - read or copy the bytes it was given (BytesLast: 4 GiB, 1 GiB under
      --gpuverify, 2 x 4 GiB for --gpubench, whose -s is per worker);
    - book one IO latency per op (the histogram counts those bytes /
      block values; the slice phase also one entry latency per stripe),
      print the JSON histogram's percentiles in its 'IO lat
      pcts' row, rising, with min <= avg <= max;
    - show a CPU use above 0 over the whole phase ('CPU util %' last
      done) where /proc/stat advances; where the host's /proc/stat is
      frozen (some container runtimes report every counter as 0), the
      meter has nothing to read and the row must be 0;
    - launch the fingerprint kernel once per block under --gpuverify
      (the slice phase once per stripe and once for its warm-up).

    Prints each run's p50, p99 and p99.9 IO latency, CPU use and rate.
    Returns the fingerprint launches."""
    from elbencho_tpu_torch.stats.latency_histogram import LatencyHistogram
    from elbencho_tpu_torch.stats.statistics import CSV_RESULT_COLUMNS
    t_start = time.monotonic()
    path = os.path.join(work, "smoke.bin")
    csv_path = os.path.join(work, "output.csv")
    res_path = os.path.join(work, "output.txt")
    json_path = os.path.join(work, "output.json")
    common = ["-b", "16M", "--iodepth", "4", "--gpuids", "0",
              *OUTPUT_FLAGS, "--label", OUTPUT_LABEL, "--csvfile", csv_path,
              "--resfile", res_path]
    verify_blocks = OUTPUT_VERIFY_SIZE // MAIN_BLOCK
    runs = (  # (name, arguments, phases, bytes, fingerprint launches)
        ("-r, staged, fused ring", ["-r", "-t", "2", "--gpustream", "on",
                                    path], ["READ"], MAIN_SIZE, 0),
        ("-r, staged, Python loop", ["-r", "-t", "2", "--gpustream", "off",
                                     path], ["READ"], MAIN_SIZE, 0),
        ("-r --gpudirect, fused ring", ["-r", "-t", "2", "--gpudirect",
                                        "--gpustream", "on", path],
         ["READ"], MAIN_SIZE, 0),
        ("-r --gpudirect, Python loop", ["-r", "-t", "2", "--gpudirect",
                                         "--gpustream", "off", path],
         ["READ"], MAIN_SIZE, 0),
        ("-r --gpudirect --gpuverify, -s 1g",
         ["-r", "-t", "2", "-s", f"{OUTPUT_VERIFY_SIZE >> 20}M",
          "--gpudirect", "--verify", "7", "--gpuverify", path], ["READ"],
         OUTPUT_VERIFY_SIZE, verify_blocks),
        ("--gpubench h2d -s 4g", ["--gpubench", "--gpubenchpat", "h2d",
                                  "-t", "2", "-s", f"{MAIN_SIZE >> 20}M"],
         ["TPUBENCH"], 2 * MAIN_SIZE, 0),  # -s is per worker
        ("--gpuslice -t 4", ["--gpuslice", "-t", "4", path], ["TPUSLICE"],
         MAIN_SIZE, SLICE_STRIPES + 1),
    )
    proc_stat_moves = _proc_stat_moves()
    print(f"  /proc/stat "
          f"{'advances' if proc_stat_moves else 'does not advance'} over a "
          f"0.2 s busy loop: CPU util must be "
          f"{'above 0' if proc_stat_moves else '0 (nothing to read)'}")
    total = 0
    csv_rows = 0
    for name, args, phases, want_bytes, want_launches in runs:
        if os.path.exists(res_path):
            os.unlink(res_path)
        out = _Tee(sys.stdout)
        with contextlib.redirect_stdout(out):
            recs, launches = run_pass(name, common + args, json_path, phases)
        printed = [line for line in out.text.getvalue().splitlines()
                   if line.startswith(("OPERATION", "    ")) or
                   line[:12].rstrip() in phases]
        with open(res_path) as f:
            res_lines = f.read().splitlines()
        if res_lines != [line for line in printed
                         if not line.startswith("=====")]:
            fail(f"pass '{name}': the result file is not the printed "
                 f"table without its rule line:\n" + "\n".join(res_lines))
        with open(csv_path) as f:
            lines = f.read().splitlines()
        header = lines[0].split(",")
        if tuple(header[:len(CSV_RESULT_COLUMNS)]) != CSV_RESULT_COLUMNS \
                or lines.count(lines[0]) != 1:
            fail(f"pass '{name}': the CSV header is {lines[0][:200]}...")
        new_rows = lines[1 + csv_rows:]
        csv_rows += len(new_rows)
        if len(new_rows) != len(recs):
            fail(f"pass '{name}': {len(new_rows)} CSV rows for "
                 f"{len(recs)} phases")
        pcts_rows = [line for line in res_lines if "IO lat pcts :" in line]
        for row, rec, pct_row in zip(new_rows, recs, pcts_rows,
                                     strict=True):
            values = dict(zip(header, row.split(","), strict=True))
            for col in CSV_RESULT_COLUMNS:
                if col in rec and values[col] != \
                        str(rec[col]).replace(",", ";"):
                    fail(f"pass '{name}': CSV column {col} is "
                         f"{values[col]!r}, the JSON record "
                         f"{rec[col]!r}")
            if values["Label"] != OUTPUT_LABEL.replace(",", ";"):
                fail(f"pass '{name}': CSV label {values['Label']!r}")
            expect(name, rec, BytesLast=want_bytes,
                   ops=want_bytes // MAIN_BLOCK)
            if rec["Phase"] == "TPUSLICE":
                expect(name, rec, EntriesLast=SLICE_STRIPES)
                if rec["EntLatHisto"]["LatNumValues"] != SLICE_STRIPES:
                    fail(f"pass '{name}': "
                         f"{rec['EntLatHisto']['LatNumValues']} entry "
                         f"latencies for {SLICE_STRIPES} stripes")
            histo = LatencyHistogram.from_dict(rec["IOLatHisto"])
            want = " ".join(f"{k}={v:.0f}" for k, v in
                            histo.percentiles_nines(3).items())
            if pct_row.split(":", 1)[1].strip() != want:
                fail(f"pass '{name}': '{pct_row.strip()}' is not the JSON "
                     f"histogram's {want}")
            pct = histo.percentiles_nines(3)
            if list(pct.values()) != sorted(pct.values()) or not \
                    rec["IOLatUSecMin"] <= rec["IOLatUSecAvg"] \
                    <= rec["IOLatUSecMax"]:
                fail(f"pass '{name}': latencies out of order: {pct}, min "
                     f"{rec['IOLatUSecMin']} avg {rec['IOLatUSecAvg']} max "
                     f"{rec['IOLatUSecMax']}")
            if (rec["CPUUtil"] > 0) != proc_stat_moves:
                fail(f"pass '{name}': CPU util {rec['CPUUtil']} % over "
                     f"{rec['ElapsedUSecLast']} us, where /proc/stat "
                     f"{'advances' if proc_stat_moves else 'is frozen'}")
            print(f"  {name}: {rec['Phase']} p50 {pct['p50']:.0f} us, p99 "
                  f"{pct['p99']:.0f} us, p99.9 {pct['p99.9']:.0f} us "
                  f"({histo.num_values} ops), CPU util "
                  f"{rec['CPUUtilStoneWall']} % / {rec['CPUUtil']} % "
                  f"(first / last done), {rec['MiBPerSecLast']} MiB/s, "
                  f"device {rec['TpuHbmMiBPerSec']} MiB/s")
        if launches != want_launches:
            fail(f"pass '{name}': {launches} fingerprint launches, want "
                 f"{want_launches}")
        total += launches
    print(f"output pass: {time.monotonic() - t_start:.1f} s, {csv_rows} "
          f"CSV rows, {total} fingerprint launches")
    return total


LIVE_INT_MS = 250               # --liveint of the live pass
LIVE_LIMIT_S = 4                # --timelimit of its looped reads
LIVE_LABEL = "live,1"           # a comma: the live CSV escapes it to ';'
LIVE_CSV_HEADER = "ISODate,Label,Phase,Seconds,Entries,Bytes,IOPS"
RING_CHUNK = 256 << 20          # bytes a worker's ring books at once


def live_pass(work: str) -> int:
    """Live statistics at full width (-t 2 -b 16M --iodepth 4 --gpuids 0)
    with --liveint 250 --live1n --cpu --livecsv --livejson --livejsonex
    and a --label holding a comma, the console captured: -r --infloop
    --timelimit 4 of the main path's file, staged through the fused ring,
    --gpudirect through the ring and the Python loop, then the --gpudirect
    ring again with --nolive; a --gpudirect --gpuverify read of the
    file's first 1 GiB; --gpubench h2d -s 4g; --gpuslice -t 4. For each
    phase:

    - the CSV, the JSON and the console hold equally many rows (none on
      the console under --nolive), within 1 of the phase's elapsed time
      in whole --liveint;
    - Seconds and Bytes never decrease, each JSON row's Workers add up
      to its totals, and the last row's Bytes is at most BytesLast;
    - in each 4 s read at least 3 rows show Bytes advancing: the ring
      books while it runs, not only at its end;
    - the limit is overrun by at most RUN_SLACK_S, the kernel launched
      once per verified block (the slice once per stripe and its warm-up);
    - every console row's CPU column is above 0 where /proc/stat advances
      and 0 where it is frozen;
    - the CSV holds one header, and every row its 7 columns, the label's
      comma written as ';'.

    Prints each run's rows, the least and most rate between two rows (and
    in steps of the ring's 256 MiB chunk a worker), and the phase's MiB/s
    (the --gpudirect ring's beside its --nolive twin's). Returns the
    fingerprint launches."""
    t_start = time.monotonic()
    path = os.path.join(work, "smoke.bin")
    csv_path = os.path.join(work, "live.csv")
    live_json = os.path.join(work, "live.json")
    json_path = os.path.join(work, "live_results.json")
    common = ["-b", "16M", "--iodepth", "4", "--gpuids", "0", "--liveint",
              str(LIVE_INT_MS), "--live1n", "--cpu", "--livecsv", csv_path,
              "--livejson", live_json, "--livejsonex", "--label",
              LIVE_LABEL]
    looped = ["-r", "-t", "2", "--infloop", "--timelimit",
              str(LIVE_LIMIT_S)]
    verify_blocks = OUTPUT_VERIFY_SIZE // MAIN_BLOCK
    runs = (  # (name, arguments, phase, console rows, fingerprint launches)
        ("staged, fused ring", [*looped, "--gpustream", "on", path],
         "READ", True, 0),
        ("--gpudirect, fused ring", [*looped, "--gpudirect", "--gpustream",
                                     "on", path], "READ", True, 0),
        ("--gpudirect, Python loop", [*looped, "--gpudirect", "--gpustream",
                                      "off", path], "READ", True, 0),
        ("--gpudirect, fused ring, --nolive",
         [*looped, "--gpudirect", "--gpustream", "on", "--nolive", path],
         "READ", False, 0),
        ("--gpudirect --gpuverify, -s 1g",
         ["-r", "-t", "2", "-s", f"{OUTPUT_VERIFY_SIZE >> 20}M",
          "--gpudirect", "--verify", "7", "--gpuverify", path], "READ",
         True, verify_blocks),
        ("--gpubench h2d -s 4g", ["--gpubench", "--gpubenchpat", "h2d",
                                  "-t", "2", "-s", f"{MAIN_SIZE >> 20}M"],
         "TPUBENCH", True, 0),
        ("--gpuslice -t 4", ["--gpuslice", "-t", "4", path], "TPUSLICE",
         True, SLICE_STRIPES + 1),
    )
    proc_stat_moves = _proc_stat_moves()
    print(f"  /proc/stat "
          f"{'advances' if proc_stat_moves else 'does not advance'}: the "
          f"live CPU column must be "
          f"{'above 0' if proc_stat_moves else '0'}")
    total = 0
    rates = {}
    for name, args, phase, console, want_launches in runs:
        for p in (csv_path, live_json):
            if os.path.exists(p):
                os.unlink(p)
        out = _Tee(sys.stdout)
        with contextlib.redirect_stdout(out):
            (rec,), launches = run_pass(f"live: {name}", common + args,
                                        json_path, [phase], live=True)
        lines = [line for line in out.text.getvalue().splitlines()
                 if line.startswith(f"{phase}: ")]
        # a phase shorter than --liveint writes no row, so no file
        csv_lines, rows = [LIVE_CSV_HEADER], []
        if os.path.exists(csv_path):
            with open(csv_path) as f:
                csv_lines = f.read().splitlines()
        if os.path.exists(live_json):
            with open(live_json) as f:
                rows = [json.loads(line) for line in f]
        n = len(rows)
        whole = rec["ElapsedUSecLast"] // (LIVE_INT_MS * 1000)
        if csv_lines.count(LIVE_CSV_HEADER) != 1 \
                or csv_lines[0] != LIVE_CSV_HEADER:
            fail(f"live pass '{name}': the live CSV does not start with its "
                 f"one header: {csv_lines[:2]}")
        if len(csv_lines) - 1 != n or len(lines) != (n if console else 0):
            fail(f"live pass '{name}': {len(csv_lines) - 1} CSV rows, {n} "
                 f"JSON rows, {len(lines)} console rows")
        if abs(n - whole) > 1:
            fail(f"live pass '{name}': {n} rows in {rec['ElapsedUSecLast']} "
                 f"us ({whole} whole intervals of {LIVE_INT_MS} ms)")
        for line, row in zip(csv_lines[1:], rows, strict=True):
            cols = line.split(",")
            if len(cols) != 7 or cols[1] != LIVE_LABEL.replace(",", ";") \
                    or cols[2:] != [row["Phase"], str(row["Seconds"]),
                                    str(row["Entries"]), str(row["Bytes"]),
                                    str(row["IOPS"])]:
                fail(f"live pass '{name}': CSV row {line!r} against JSON "
                     f"row {row}")
            if row["Label"] != LIVE_LABEL or row["Phase"] != phase:
                fail(f"live pass '{name}': JSON row {row}")
            for key, per_worker in (("Entries", "NumEntriesDone"),
                                    ("Bytes", "NumBytesDone"),
                                    ("IOPS", "NumIOPSDone")):
                if sum(w[per_worker] for w in row["Workers"]) != row[key]:
                    fail(f"live pass '{name}': the Workers of {row} do not "
                         f"add up to its {key}")
        for key in ("Seconds", "Bytes"):
            values = [row[key] for row in rows]
            if values != sorted(values):
                fail(f"live pass '{name}': {key} goes back: {values}")
        if rows and rows[-1]["Bytes"] > rec["BytesLast"]:
            fail(f"live pass '{name}': the last row's {rows[-1]['Bytes']} "
                 f"bytes exceed BytesLast {rec['BytesLast']}")
        steps = [b - a for a, b in zip([0] + [r["Bytes"] for r in rows],
                                       [r["Bytes"] for r in rows])]
        overrun = ""
        if "--infloop" in args:
            advancing = sum(1 for step in steps if step > 0)
            slack = rec["ElapsedUSecLast"] / 1e6 - LIVE_LIMIT_S
            overrun = f" (limit + {slack:.3f} s)"
            if advancing < 3:
                fail(f"live pass '{name}': Bytes advanced in {advancing} of "
                     f"{n} rows")
            if not 0 <= slack <= RUN_SLACK_S:
                fail(f"live pass '{name}': ended {slack:.3f} s after its "
                     f"limit")
        cpus = [float(line.rsplit("; CPU ", 1)[1].rstrip("%"))
                for line in lines]
        if any((cpu > 0) != proc_stat_moves for cpu in cpus):
            fail(f"live pass '{name}': live CPU column {cpus}, where "
                 f"/proc/stat {'advances' if proc_stat_moves else 'is frozen'}")
        if launches != want_launches:
            fail(f"live pass '{name}': {launches} fingerprint launches, want "
                 f"{want_launches}")
        total += launches
        between = steps[1:]
        per_s = 2 ** 20 * LIVE_INT_MS / 1000
        spread = (f"{min(between) / per_s:,.1f}-{max(between) / per_s:,.1f} "
                  f"MiB/s ({min(between) / RING_CHUNK:.2f}-"
                  f"{max(between) / RING_CHUNK:.2f} chunks of 256 MiB)"
                  if between else "n/a (fewer than 2 rows)")
        rates[name] = rec["MiBPerSecLast"]
        print(f"  live {name}: {phase} {n} rows in "
              f"{rec['ElapsedUSecLast']} us{overrun} ({whole} whole "
              f"intervals), rate between two rows {spread}, "
              f"{sum(1 for step in steps if step > 0)} rows advancing, "
              f"phase {rec['MiBPerSecLast']} MiB/s"
              + (f" (--nolive twin "
                 f"{rates.get('--gpudirect, fused ring, --nolive')} MiB/s "
                 f"beside {rates.get('--gpudirect, fused ring')} with live "
                 f"on)" if name.endswith("--nolive") else "")
              + f", {launches} launches")
    print(f"live pass: {time.monotonic() - t_start:.1f} s, {total} "
          f"fingerprint launches")
    return total


FAULT_SHORT_EVERY = 5           # (a): every 5th storage op reads short
FAULT_SIZE = 1 << 30            # the 1 GiB reads and writes of (a), (d), (e)
FAULT_LOSS_AT = 9               # (d), (e): the copy that meets the lost GPU
CUDA_LOSS_TEXT = "CUDA error: an illegal memory access was encountered"


@contextlib.contextmanager
def short_preadv(every: int):
    """The Python loop's fault seam: every `every`th os.preadv of each
    thread returns 512 bytes short (the ring's seam is the engine's
    ELBENCHO_TPU_IO_FAULT). Per thread, so a retry never lands on the
    next fault of another worker."""
    real = os.preadv
    local = threading.local()

    def preadv(fd, bufs, off):
        n = real(fd, bufs, off)
        local.calls = getattr(local, "calls", 0) + 1
        return n - 512 if local.calls % every == 0 and n > 512 else n

    os.preadv = preadv
    try:
        yield
    finally:
        os.preadv = real


@contextlib.contextmanager
def lost_gpu(method: str, at: int):
    """A simulated lost GPU: the `at`th call of CudaWorkerContext.<method>
    in this process raises the CUDA runtime's illegal-address error, as
    the first call after a sticky error does. Yields a dict with the time
    it fired and (time, bytes) of every host-staged copy after it."""
    from elbencho_tpu_torch.cuda.device import CudaWorkerContext as ctx
    real = getattr(ctx, method)
    staged = {name: getattr(ctx, name)
              for name in ("_host_staged_h2d", "_host_staged_d2h")}
    lock = threading.Lock()
    state = {"calls": 0, "fired": None, "staged": []}

    def failing(self, *args, **kwargs):
        with lock:
            state["calls"] += 1
            fire = state["calls"] == at
        if fire:
            state["fired"] = time.monotonic()
            raise RuntimeError(CUDA_LOSS_TEXT)
        return real(self, *args, **kwargs)

    def timed(fn):
        def wrapper(self, buf, length, *args):
            fn(self, buf, length, *args)
            with lock:
                state["staged"].append((time.monotonic(), length))
        return wrapper

    setattr(ctx, method, failing)
    for name, fn in staged.items():
        setattr(ctx, name, timed(fn))
    try:
        yield state
    finally:
        setattr(ctx, method, real)
        for name, fn in staged.items():
            setattr(ctx, name, fn)


def failing_run(name: str, args: "list[str]", json_path: str,
                want: str) -> str:
    """A CLI run that must fail with `want` in its error output; returns
    that output."""
    err = _Tee()
    with contextlib.redirect_stderr(err):
        rc, _ = run_cli(args, json_path)
    text = err.text.getvalue()
    if rc == 0 or want not in text:
        fail(f"pass '{name}' exited {rc}; want a failure naming '{want}'")
    return text


def sticky_child(argv: "list[str]") -> int:
    """Runs in a child process: the CLI with `argv`, where the
    FAULT_LOSS_AT-th device->host copy first enqueues chip_sticky_fault.cu's
    store through the null pointer on the worker's own stream. The fault
    is a sticky CUDA error (cudaErrorIllegalAddress): from then on every
    call into the GPU's context fails, in both workers, as after a lost
    GPU. Returns the CLI's exit code."""
    import ctypes

    import torch
    sys.path.insert(0, REPO)
    from elbencho_tpu_torch.cli import main as cli_main
    from elbencho_tpu_torch.cuda.device import CudaWorkerContext
    from elbencho_tpu_torch.ops.cuda_build import load_library
    launch = load_library("chip_sticky_fault",
                          source_dir=REPO).sticky_fault_launch
    launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    launch.restype = ctypes.c_int
    real = CudaWorkerContext.device_to_host
    lock = threading.Lock()
    calls = [0]

    def faulting(self, *args, **kwargs):
        with lock:
            calls[0] += 1
            count = calls[0]
        if count == FAULT_LOSS_AT:
            with torch.cuda.device(self.device):
                err = launch(None, self.stream.cuda_stream)
            print(f"STICKY_FAULT enqueued on {self.device} (cudaError "
                  f"{err}) before device->host copy {count}", flush=True)
        return real(self, *args, **kwargs)

    CudaWorkerContext.device_to_host = faulting
    return cli_main(argv)


def sticky_fault_run(work: str) -> int:
    """(e): a real sticky CUDA error in a child process under
    --gpufallback host; then this process verifies the child's file.
    Returns the fingerprint launches of that read (none where the child
    could not outlive the error)."""
    path = os.path.join(work, "sticky.bin")
    json_path = os.path.join(work, "sticky.json")
    args = ["-w", "-t", "2", "-b", f"{MAIN_BLOCK >> 20}M", "-s",
            f"{FAULT_SIZE >> 20}M", "--iodepth", "4", "--gpuids", "0",
            "--verify", "7", "--gpufallback", "host", "--nolive",
            "--jsonfile", json_path, path]
    t0 = time.monotonic()
    try:
        proc = subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "sys.exit(chip_smoke.sticky_child(sys.argv[1:]))", *args],
            cwd=REPO, capture_output=True, text=True, timeout=300)
    except subprocess.TimeoutExpired:
        fail("the sticky-fault child hung (no exit within 300 s)")
    secs = time.monotonic() - t0
    sys.stdout.write(proc.stdout)
    sys.stdout.write(proc.stderr)  # its error lines are the finding
    if "STICKY_FAULT enqueued" not in proc.stdout:
        fail("the sticky-fault child never enqueued the faulting store")
    if proc.returncode < 0 or "Traceback" in proc.stderr:
        fail(f"the sticky-fault child died (exit {proc.returncode}) or "
             f"raised past the guard")
    if proc.returncode != 0:
        # the run carried on no further: it must say why, in words
        if "lost" not in proc.stderr and "CUDA" not in proc.stderr:
            fail(f"the sticky-fault child exited {proc.returncode} "
                 f"without a clear error")
        print(f"FINDING (e): a sticky CUDA error was not outlived in one "
              f"process: the child exited {proc.returncode} after "
              f"{secs:.1f} s with the error above")
        return 0
    with open(json_path) as f:
        (child,) = [json.loads(line) for line in f]
    expect("sticky-fault child", child, BytesLast=FAULT_SIZE,
           TpuChipFailovers=1)
    if "degraded to host-memory staging" not in proc.stderr:
        fail("the sticky-fault child logged no failover to host staging")
    reached = [line.split("ERROR: ", 1)[1]
               for line in proc.stderr.splitlines()
               if "lost mid-phase" in line]
    warnings = sum("CUDA warning" in line for line in proc.stderr.splitlines())
    _, launches = run_pass(
        "fresh --gpuverify read of the sticky-fault child's file",
        ["-r", "-t", "2", "-b", f"{MAIN_BLOCK >> 20}M", "-s",
         f"{FAULT_SIZE >> 20}M", "--iodepth", "4", "--gpuids", "0",
         "--verify", "7", "--gpuverify", path],
        os.path.join(work, "sticky_read.json"), ["READ"])
    blocks = FAULT_SIZE // MAIN_BLOCK
    if launches != blocks:
        fail(f"the fresh read of the child's file made {launches} "
             f"launches for {blocks} blocks")
    os.unlink(path)
    print(f"(e) a real sticky CUDA error in a child process, --gpufallback "
          f"host: exit 0 after {secs:.1f} s, TpuChipFailovers 1, "
          f"{child['BytesLast']} bytes at {child['MiBPerSecLast']} MiB/s, "
          f"{child['TpuD2hStagedOps']} device->host copies (on the card, "
          f"then host-staged); the errors that reached the guard: "
          f"{reached}; {warnings} CUDA warnings of torch's destructors; a "
          f"fresh process verified the file ({launches} launches)")
    return launches


def fault_pass(work: str) -> int:
    """Data-plane fault tolerance on the card, at the main path's width
    (-t 2 -b 16M --iodepth 4 --gpuids 0) on its 4 GiB file (the verify
    pattern of salt 7), with ELBENCHO_TPU_TESTING=1 set for this pass
    only. Returns the fingerprint launches.

    (a) --ioretries 3 with every 5th storage op short (the ring: the
        engine's short:5:0:first, which counts and faults first submits
        only, so that a retry never lines up with the schedule; the
        Python loop: short_preadv), staged and
        --gpudirect, each beside a clean read in this run: exit 0, the
        whole file, IoRetries at least ops/5; a short:5 --verify 7 read
        of the ring; a 1 GiB --gpudirect --gpuverify short:5 read with
        one launch per block;
    (b) hang:13 --iotimeout 1 --ioretries 3: exit 0, IoTimeouts at least
        1, IoRetries at least IoTimeouts;
    (c) eio:7: fails with --ioretries 3 unless is_netfs_path says the
        file is on a network file system (then it passes), and fails
        without --ioretries;
    (d) a simulated lost GPU (lost_gpu): --gpufallback host on the 1 GiB
        --gpudirect --gpuverify read (exit 0, TpuChipFailovers 1, every
        block verified, on the card or on the host: fewer launches than
        blocks) and on a --verify 7 write that a fresh read verifies;
        the default aborts and names --gpufallback;
    (e) a real sticky CUDA error in a child process (sticky_fault_run).

    Prints each run's MiB/s, retries, timeouts and failovers, the time
    from the loss to the first host-staged copy and the failed-over
    worker's rate after it."""
    from elbencho_tpu_torch.workers.io_errors import is_netfs_path
    t_start = time.monotonic()
    path = os.path.join(work, "smoke.bin")
    json_path = os.path.join(work, "fault.json")
    common = ["-t", "2", "-b", f"{MAIN_BLOCK >> 20}M", "--iodepth",
              str(TREE_IODEPTH),
              "--gpuids", "0"]
    retries = ["--ioretries", "3"]
    os.environ["ELBENCHO_TPU_TESTING"] = "1"
    total = 0
    try:
        print(f"fault pass (a): --ioretries 3, every "
              f"{FAULT_SHORT_EVERY}th storage op short")
        for loop, flags in (("staged, fused ring", ["--gpustream", "on"]),
                            ("staged, Python loop", ["--gpustream", "off"]),
                            ("--gpudirect, fused ring",
                             ["--gpudirect", "--gpustream", "on"]),
                            ("--gpudirect, Python loop",
                             ["--gpudirect", "--gpustream", "off"])):
            fused = "fused" in loop
            (clean,), _ = run_pass(f"clean read, {loop}",
                                   ["-r", *common, *flags, path],
                                   json_path, ["READ"])
            name = f"short:{FAULT_SHORT_EVERY} read, {loop}"
            if fused:
                os.environ["ELBENCHO_TPU_IO_FAULT"] = \
                    f"short:{FAULT_SHORT_EVERY}:0:first"
                seam = contextlib.nullcontext()
            else:
                seam = short_preadv(FAULT_SHORT_EVERY)
            with seam:
                (rec,), _ = run_pass(name, ["-r", *common, *flags,
                                            *retries, path],
                                     json_path, ["READ"])
            os.environ.pop("ELBENCHO_TPU_IO_FAULT", None)
            expect(name, rec, BytesLast=MAIN_SIZE, TpuHbmBytes=MAIN_SIZE,
                   ops=MAIN_BLOCKS,
                   TpuStreamFusedOps=MAIN_BLOCKS if fused else 0)
            if rec["IoRetries"] < MAIN_BLOCKS / FAULT_SHORT_EVERY:
                fail(f"pass '{name}': {rec['IoRetries']} retries for "
                     f"{MAIN_BLOCKS} ops")
            print(f"  {name}: {rec['MiBPerSecLast']} MiB/s against "
                  f"{clean['MiBPerSecLast']} clean "
                  f"({rec['MiBPerSecLast'] / clean['MiBPerSecLast']:.3f}x)"
                  f", {rec['IoRetries']} retries, "
                  f"{rec['IoRetryUsec']} us of backoff")
        os.environ["ELBENCHO_TPU_IO_FAULT"] = \
            f"short:{FAULT_SHORT_EVERY}:0:first"
        name = f"short:{FAULT_SHORT_EVERY} --verify 7 read, fused ring"
        (rec,), _ = run_pass(name, ["-r", *common, "--verify", "7",
                                    *retries, path], json_path, ["READ"])
        expect(name, rec, BytesLast=MAIN_SIZE, ops=MAIN_BLOCKS)
        print(f"  {name}: verified, {rec['MiBPerSecLast']} MiB/s, "
              f"{rec['IoRetries']} retries")
        name = (f"short:{FAULT_SHORT_EVERY} 1 GiB --gpudirect --gpuverify "
                f"read, fused ring")
        (rec,), launches = run_pass(
            name, ["-r", *common, "-s", f"{FAULT_SIZE >> 20}M",
                   "--gpudirect", "--verify", "7", "--gpuverify", *retries,
                   path], json_path, ["READ"])
        blocks = FAULT_SIZE // MAIN_BLOCK
        expect(name, rec, BytesLast=FAULT_SIZE, ops=blocks)
        if launches != blocks or rec["IoRetries"] < blocks / 5:
            fail(f"pass '{name}': {launches} launches for {blocks} blocks, "
                 f"{rec['IoRetries']} retries")
        print(f"  {name}: {rec['MiBPerSecLast']} MiB/s, {launches} launches"
              f", {rec['IoRetries']} retries")
        total += launches

        os.environ["ELBENCHO_TPU_IO_FAULT"] = "hang:13:0:first"
        name = "(b) hang:13 read --iotimeout 1 --ioretries 3, fused ring"
        (rec,), _ = run_pass(name, ["-r", *common, "--iotimeout", "1",
                                    *retries, path], json_path, ["READ"])
        expect(name, rec, BytesLast=MAIN_SIZE, ops=MAIN_BLOCKS)
        if not 1 <= rec["IoTimeouts"] <= rec["IoRetries"]:
            fail(f"pass '{name}': {rec['IoTimeouts']} timeouts, "
                 f"{rec['IoRetries']} retries")
        print(f"  {name}: {rec['MiBPerSecLast']} MiB/s, "
              f"{rec['IoTimeouts']} timeouts, {rec['IoRetries']} retries")

        os.environ["ELBENCHO_TPU_IO_FAULT"] = "eio:7:0:first"
        netfs = is_netfs_path(path)
        name = "(c) eio:7 read --ioretries 3"
        if netfs:
            (rec,), _ = run_pass(name, ["-r", *common, *retries, path],
                                 json_path, ["READ"])
            expect(name, rec, BytesLast=MAIN_SIZE)
        else:
            failing_run(name, ["-r", *common, *retries, path], json_path,
                        "Input/output error")
        failing_run("(c) eio:7 read without --ioretries",
                    ["-r", *common, path], json_path, "Input/output error")
        print(f"  (c) eio:7: the file is {'on' if netfs else 'not on'} a "
              f"network file system (is_netfs_path), so with --ioretries "
              f"3 the read {'passed' if netfs else 'failed fast'}; "
              f"without --ioretries it failed")
        os.environ.pop("ELBENCHO_TPU_IO_FAULT", None)

        print(f"fault pass (d): a simulated lost GPU at copy "
              f"{FAULT_LOSS_AT}")
        name = "(d) 1 GiB --gpudirect --gpuverify read, --gpufallback host"
        with lost_gpu("host_to_device", FAULT_LOSS_AT) as state:
            (rec,), launches = run_pass(
                name, ["-r", *common, "-s", f"{FAULT_SIZE >> 20}M",
                       "--gpudirect", "--verify", "7", "--gpuverify",
                       "--gpufallback", "host", path], json_path, ["READ"])
        expect(name, rec, BytesLast=FAULT_SIZE, TpuChipFailovers=1)
        host_blocks = len(state["staged"])
        if not 0 < launches < blocks or launches + host_blocks != blocks:
            fail(f"pass '{name}': {launches} launches and {host_blocks} "
                 f"host-verified blocks for {blocks} blocks")
        first, last = state["staged"][0][0], state["staged"][-1][0]
        staged_mib = sum(n for _t, n in state["staged"]) / (1 << 20)
        rate = (f"{staged_mib / (last - first):.2f} MiB/s"
                if last > first else "not measured (one block)")
        print(f"  {name}: {rec['MiBPerSecLast']} MiB/s, {launches} blocks "
              f"verified by the kernel and {host_blocks} on the host after "
              f"the failover (0 never verified), loss to first host-staged "
              f"copy {(first - state['fired']) * 1e6:.0f} us, the "
              f"failed-over worker's rate after it {rate}")
        total += launches
        fault_file = os.path.join(work, "fault.bin")
        name = "(d) 1 GiB --verify 7 write, --gpufallback host"
        with lost_gpu("device_to_host", FAULT_LOSS_AT) as state:
            (rec,), _ = run_pass(
                name, ["-w", *common, "-s", f"{FAULT_SIZE >> 20}M",
                       "--verify", "7", "--gpufallback", "host",
                       fault_file], json_path, ["WRITE"])
        expect(name, rec, BytesLast=FAULT_SIZE, TpuChipFailovers=1)
        (read,), launches = run_pass(
            "fresh --gpuverify read of the failed-over write",
            ["-r", *common, "--verify", "7", "--gpuverify", fault_file],
            json_path, ["READ"])
        if launches != blocks:
            fail(f"the read of the failed-over write made {launches} "
                 f"launches for {blocks} blocks")
        print(f"  {name}: {rec['MiBPerSecLast']} MiB/s, "
              f"{len(state['staged'])} host-staged blocks; a fresh read "
              f"verified it ({launches} launches)")
        total += launches
        os.unlink(fault_file)
        with lost_gpu("host_to_device", FAULT_LOSS_AT):
            text = failing_run("(d) read, the default --gpufallback abort",
                               ["-r", *common, "-s", f"{FAULT_SIZE >> 20}M",
                                path], json_path, "--gpufallback")
        print(f"  (d) the default aborts: "
              f"{[ln for ln in text.splitlines() if 'GPU 0 lost' in ln][:1]}")
    finally:
        os.environ.pop("ELBENCHO_TPU_TESTING", None)
        os.environ.pop("ELBENCHO_TPU_IO_FAULT", None)

    print("fault pass (e): a real sticky CUDA error in a child process")
    total += sticky_fault_run(work)
    print(f"fault pass: {time.monotonic() - t_start:.1f} s, {total} "
          f"fingerprint launches")
    return total


def signal_children(work: str) -> int:
    """The two-stage SIGINT in child processes of the CLI on the card.
    Returns the first child's fingerprint launches."""
    path = os.path.join(work, "smoke.bin")
    json_path = os.path.join(work, "signal.json")
    common = ["-t", "2", "-b", "16M", "--iodepth", "4", "--gpuids", "0",
              "--verify", "7", "--gpuverify", "--gpudirect", "--nolive",
              "--jsonfile", json_path, path]

    def spawn(args):
        if os.path.exists(json_path):
            os.unlink(json_path)
        return subprocess.Popen(
            [sys.executable, "-u", "-c", _CHILD_CLI, *args], cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def finish(child):
        try:
            out, err = child.communicate(timeout=120)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        sys.stdout.write(out)
        sys.stderr.write(err)
        if any(text in err for text in ("CUDA error", "Traceback",
                                        "failed")):
            fail("a signalled child printed an error")
        with open(json_path) as f:
            return out, [json.loads(line) for line in f]

    child = spawn(["-r", "--infloop", *common])
    for line in child.stdout:
        sys.stdout.write(line)
        if "OPERATION" in line:
            break
    time.sleep(SIGNAL_AFTER_S)
    t0 = time.monotonic()
    child.send_signal(signal.SIGINT)
    out, recs = finish(child)
    secs = time.monotonic() - t0
    launches = int(out.rsplit("FINGERPRINT_LAUNCHES", 1)[1].split()[0])
    if child.returncode != 3 or [r["Phase"] for r in recs] != ["READ"]:
        fail(f"the SIGINT child exited {child.returncode} with "
             f"{[r['Phase'] for r in recs]}, want 3 and a READ record")
    rec = recs[0]
    ops = device_ops(rec)
    expect("SIGINT child", rec, TpuHbmBytes=ops * MAIN_BLOCK,
           BytesLast=ops * MAIN_BLOCK)
    if launches != ops or not ops:
        fail(f"the SIGINT child made {launches} launches for {ops} blocks")
    print(f"SIGINT child: exit 3 {secs:.2f} s after the signal, "
          f"{rec['MiBPerSecLast']} MiB/s over {rec['ElapsedUSecLast']} us, "
          f"{rec['BytesLast'] / MAIN_SIZE:.2f} passes, {launches} launches")

    child = spawn(["--stat", "-r", "--phasedelay", "600", *common])
    deadline = time.monotonic() + 120
    while not (os.path.exists(json_path)
               and open(json_path).read().endswith("\n")):
        if time.monotonic() > deadline or child.poll() is not None:
            child.kill()
            fail("the second signal child did not finish its first phase")
        time.sleep(0.1)
    child.send_signal(signal.SIGINT)
    time.sleep(1.0)
    child.send_signal(signal.SIGINT)
    _out, recs = finish(child)
    if child.returncode != -signal.SIGINT or \
            [r["Phase"] for r in recs] != ["STAT"]:
        fail(f"the twice-signalled child exited {child.returncode}, want "
             f"{-signal.SIGINT} (killed by SIGINT)")
    print(f"twice-signalled child: killed by SIGINT in the phase delay "
          f"(exit {child.returncode})")
    return launches


RWMIX_PCT = 30                 # --rwmixpct of (a)
RWMIX_LIMIT = 512 << 20        # --limitread/--limitwrite of (c)
RWMIX_CUT_LIMIT = 256 << 20    # --limitread of the time-limited read
RWMIX_CUT_S = 3                # its --timelimit
RWMIX_VAR_SIZE = 1 << 30       # -s 1g of (d)


def rule_split(ranks: int, ops: int, pct: int) -> "tuple[int, int, int]":
    """(reads, writes, write runs) of a --rwmixpct write phase: op i of
    rank r reads when (r + i) % 100 < pct. A write run is a write whose
    previous op of its worker was a read, or its worker's first op: the
    one D2H copy of a run that the speculation cannot have served."""
    reads = runs = 0
    for rank in range(ranks):
        prev_read = True
        for i in range(ops):
            rd = (rank + i) % 100 < pct
            reads += rd
            runs += prev_read and not rd
            prev_read = rd
    return reads, ranks * ops - reads, runs


def speculation(rec: dict) -> str:
    """The D2H copies of a WRITE record served by the speculative
    verify-pattern ring and those issued fresh."""
    d2h = rec["TpuD2hStagedOps"] + rec["TpuD2hDirectOps"]
    hits = rec["TpuD2hPrefetchHits"]
    return (f"D2H {d2h}: {hits} served by the speculation, {d2h - hits} "
            f"fresh, {rec['TpuD2hPrefetchMisses']} misses")


def rwmix_rates(rec: dict, ops: int, nbytes: int) -> "tuple[float, float]":
    """RWMixReadIOPSLast and RWMixReadMiBPerSecLast of `ops` reads of
    `nbytes`, computed as the statistics module computes them."""
    last_s = rec["ElapsedUSecLast"] / 1e6
    return round(ops / last_s, 2), round(nbytes / last_s / (1 << 20), 2)


def half_digests(path: str, block: int) -> "tuple[int, int, int]":
    """(blocks, distinct first halves, distinct second halves)."""
    import hashlib
    first, second = set(), set()
    n = 0
    with open(path, "rb") as f:
        while chunk := f.read(block):
            n += 1
            first.add(hashlib.sha1(chunk[:block // 2]).digest())
            second.add(hashlib.sha1(chunk[block // 2:]).digest())
    return n, len(first), len(second)


def file_digest(path: str) -> str:
    import hashlib
    h = hashlib.sha1()
    with open(path, "rb") as f:
        while chunk := f.read(MAIN_BLOCK):
            h.update(chunk)
    return h.hexdigest()


def rwmix_pass(work: str) -> int:
    """Mixed and rate-shaped traffic on the card at the main path's width
    (-t 2 -b 16M --iodepth 4 --gpuids 0) on its 4 GiB file, which holds
    the verify pattern of salt 7. Returns the fingerprint launches.

    (a) -w --rwmixpct 30 --verify 7 --gpuverify through the fused ring
        and the Python loop, staged and --gpudirect: reads and writes of
        one worker through one device context, the reads' H2D copies and
        kernel launches interleaved with the writes' speculative D2H
        copies. Each run: exit 0, the rule's 116 rwmix reads and 140
        writes (2,348,810,240 bytes), the whole file in TpuHbmBytes, 256
        ring ops or none, one launch per read; then a --gpuverify read
        of the whole file (256 launches), so that no stale pattern was
        written.
    (b) -w --rwmixthr 1: rank 0 reads its 2 GiB, booked as rwmix reads,
        rank 1 writes its 2 GiB (BytesLast), both in TpuHbmBytes; then
        with --rwmixthrpct 50, where the balancer sends the phase to the
        Python loop with a NOTE naming it.
    (c) -r --limitread 512M and -w --limitwrite 512M of 2 GiB a worker,
        with the device (the Python loop, its NOTE naming the limits)
        and without (the engine's block loop): four windows, so at least
        3 s and at most 2 x 512 x 4/3 MiB/s; then -r --limitread 256M
        --timelimit 3, both loops, within RUN_SLACK_S of the limit.
    (d) -w --blockvarpct 50 -s 1g without a device: every block's first
        half differs from every other's, the second halves (the staging
        slot's fill) repeat; with the device the file is byte-equal to
        the same write without --blockvarpct (the fill pool is the
        source)."""
    t_start = time.monotonic()
    path = os.path.join(work, "smoke.bin")
    json_path = os.path.join(work, "rwmix.json")
    common = ["-t", "2", "-b", f"{MAIN_BLOCK >> 20}M", "--iodepth", "4"]
    dev = ["--gpuids", "0"]
    verify = ["--verify", "7", "--gpuverify"]
    reads, writes, runs = rule_split(2, MAIN_BLOCKS // 2, RWMIX_PCT)
    total = 0
    print(f"rwmix pass (a): -w --rwmixpct {RWMIX_PCT} --verify 7 "
          f"--gpuverify, {reads} reads and {writes} writes by the rule")
    for loop, flags in (("staged, fused ring", ["--gpustream", "on"]),
                        ("staged, Python loop", ["--gpustream", "off"]),
                        ("--gpudirect, fused ring",
                         ["--gpudirect", "--gpustream", "on"]),
                        ("--gpudirect, Python loop",
                         ["--gpudirect", "--gpustream", "off"])):
        fused = "fused" in loop
        name = f"rwmix {RWMIX_PCT}% write, {loop}"
        (rec,), launches = run_pass(
            name, ["-w", *common, *dev, *verify, "--rwmixpct",
                   str(RWMIX_PCT), *flags, path], json_path, ["WRITE"])
        total += launches
        expect(name, rec, BytesLast=writes * MAIN_BLOCK, ops=writes,
               device_ops=writes, TpuHbmBytes=MAIN_SIZE,
               TpuStreamFusedOps=MAIN_BLOCKS if fused else 0,
               TpuD2hPrefetchHits=writes - runs, TpuD2hPrefetchMisses=0)
        want = rwmix_rates(rec, reads, reads * MAIN_BLOCK)
        got = (rec["RWMixReadIOPSLast"], rec["RWMixReadMiBPerSecLast"])
        if got != want:
            fail(f"pass '{name}': rwmix read rates {got}, want {want} "
                 f"({reads} reads of {reads * MAIN_BLOCK} bytes)")
        if launches != reads:
            fail(f"pass '{name}': {launches} fingerprint launches, want "
                 f"{reads} (one per rwmix read)")
        print(f"  {name}: {loop_taken(rec)}, write {rec['MiBPerSecLast']} "
              f"MiB/s, rwmix read {rec['RWMixReadMiBPerSecLast']} MiB/s, "
              f"device {rec['TpuHbmMiBPerSec']} MiB/s, {speculation(rec)}, "
              f"{launches} launches")
        (check,), launches = run_pass(
            f"--gpuverify read after '{name}'",
            ["-r", *common, *dev, *verify, path], json_path, ["READ"])
        total += launches
        expect("--gpuverify read", check, BytesLast=MAIN_SIZE)
        if launches != MAIN_BLOCKS:
            fail(f"the --gpuverify read after '{name}' launched the kernel "
                 f"{launches} times, want {MAIN_BLOCKS}")

    half = MAIN_SIZE // 2
    print("rwmix pass (b): -w --rwmixthr 1")
    for name, flags in (("--rwmixthr 1", []),
                        ("--rwmixthr 1 --rwmixthrpct 50",
                         ["--rwmixthrpct", "50"])):
        out = _Tee(sys.stdout)
        with contextlib.redirect_stdout(out):
            (rec,), launches = run_pass(
                name, ["-w", *common, *dev, "--rwmixthr", "1", *flags,
                       path], json_path, ["WRITE"])
        expect(name, rec, BytesLast=half, ops=MAIN_BLOCKS // 2,
               TpuHbmBytes=MAIN_SIZE)
        want = rwmix_rates(rec, MAIN_BLOCKS // 2, half)
        got = (rec["RWMixReadIOPSLast"], rec["RWMixReadMiBPerSecLast"])
        if got != want:
            fail(f"pass '{name}': rwmix read rates {got}, want {want} (the "
                 f"reader's {half} bytes)")
        note = ("NOTE: fused GPU stream ineligible (--rwmixthr byte-ratio "
                "balancer); using the Python loop")
        if flags and (note not in out.text.getvalue()
                      or rec["TpuStreamFusedOps"]):
            fail(f"pass '{name}' did not take the Python loop with the "
                 f"balancer's NOTE")
        if not flags and rec["TpuStreamFusedOps"] != MAIN_BLOCKS:
            fail(f"pass '{name}': {rec['TpuStreamFusedOps']} ring ops, want "
                 f"{MAIN_BLOCKS}")
        print(f"  {name}: {loop_taken(rec)}, write {rec['MiBPerSecLast']} "
              f"MiB/s, rwmix read {rec['RWMixReadMiBPerSecLast']} MiB/s, "
              f"device {rec['TpuHbmMiBPerSec']} MiB/s")

    limit_mib = RWMIX_LIMIT >> 20
    max_rate = 2 * limit_mib * 4 / 3
    print(f"rwmix pass (c): --limitread/--limitwrite {limit_mib}M, 2 GiB a "
          f"worker (four windows)")
    for op, flag in (("-r", "--limitread"), ("-w", "--limitwrite")):
        for loop, extra in (("Python loop", dev), ("native block loop", [])):
            name = f"{op} {flag} {limit_mib}M, {loop}"
            out = _Tee(sys.stdout)
            with contextlib.redirect_stdout(out):
                (rec,), _ = run_pass(
                    name, [op, *common, *extra, flag, f"{limit_mib}M", path],
                    json_path, ["READ" if op == "-r" else "WRITE"],
                    on_device=bool(extra))
            expect(name, rec, BytesLast=MAIN_SIZE, ops=MAIN_BLOCKS,
                   TpuStreamFusedOps=0)
            secs = rec["ElapsedUSecLast"] / 1e6
            if secs < 3 or rec["MiBPerSecLast"] > max_rate:
                fail(f"pass '{name}': {secs:.3f} s at "
                     f"{rec['MiBPerSecLast']} MiB/s; want at least 3 s and "
                     f"at most {max_rate:.2f} MiB/s")
            note = ("NOTE: fused GPU stream ineligible (per-op rate "
                    "limits); using the Python loop")
            if extra and note not in out.text.getvalue():
                fail(f"pass '{name}' printed no NOTE naming the limits")
            print(f"  {name}: {rec['MiBPerSecLast']} MiB/s against "
                  f"{2 * limit_mib} MiB/s of limits "
                  f"({rec['MiBPerSecLast'] / (2 * limit_mib):.3f}x), "
                  f"{secs:.3f} s")
    cut_mib = RWMIX_CUT_LIMIT >> 20
    for loop, extra in (("Python loop", dev), ("native block loop", [])):
        name = f"-r --limitread {cut_mib}M --timelimit {RWMIX_CUT_S}, {loop}"
        (rec,), _ = run_pass(
            name, ["-r", *common, *extra, "--limitread", f"{cut_mib}M",
                   "--timelimit", str(RWMIX_CUT_S), path],
            json_path, ["READ"], on_device=bool(extra))
        over = rec["ElapsedUSecLast"] / 1e6 - RWMIX_CUT_S
        if over > RUN_SLACK_S or rec["BytesLast"] % MAIN_BLOCK:
            fail(f"pass '{name}': overran its limit by {over:.3f} s "
                 f"(bound {RUN_SLACK_S} s), or booked a part block")
        print(f"  {name}: overrun {over:.3f} s, {rec['MiBPerSecLast']} MiB/s "
              f"against {2 * cut_mib} MiB/s of limits")

    var_path = os.path.join(work, "var.bin")
    var = ["-w", *common, "-s", f"{RWMIX_VAR_SIZE >> 20}M"]
    var_blocks = RWMIX_VAR_SIZE // MAIN_BLOCK
    print("rwmix pass (d): --blockvarpct 50, 1 GiB")
    run_pass("--blockvarpct 50, no device",
             [*var, "--blockvarpct", "50", var_path], json_path, ["WRITE"],
             on_device=False)
    n, firsts, seconds = half_digests(var_path, MAIN_BLOCK)
    if n != var_blocks or firsts != n or seconds >= n:
        fail(f"--blockvarpct 50: {n} blocks, {firsts} distinct first halves "
             f"(want {n}), {seconds} distinct second halves (want fewer)")
    print(f"  no device: {n} blocks, {firsts} distinct first halves, "
          f"{seconds} distinct second halves")
    digests = []
    for flags in ([], ["--blockvarpct", "50"]):
        run_pass(f"-w {' '.join(flags) or 'plain'}, device",
                 [*var, *dev, *flags, var_path], json_path, ["WRITE"])
        digests.append(file_digest(var_path))
    if digests[0] != digests[1]:
        fail("--blockvarpct 50 with a device changed the written bytes")
    print(f"  with the device: the file equals the plain write's "
          f"(sha1 {digests[0][:16]}...)")
    os.unlink(var_path)
    print(f"rwmix pass: {time.monotonic() - t_start:.1f} s, {total} "
          f"fingerprint launches")
    return total


BLOCKMOD_SIZE = 1 << 30        # -s 1g of the per-op feature pass
BLOCKMOD_LIMIT_S = 90          # the most the pass may take


@contextlib.contextmanager
def engine_calls():
    """The per-op feature arguments of every call into the native
    engine's block loop while the block runs: a list of (flock_mode,
    inline_readback, an ops-log fd given, ops_lock)."""
    from elbencho_tpu_torch.utils.native import _NativeEngine
    real = _NativeEngine.run_block_loop
    calls = []

    def spy(self, *args, **kwargs):
        calls.append((kwargs.get("flock_mode", 0),
                      bool(kwargs.get("inline_readback")),
                      kwargs.get("ops_fd", -1) >= 0,
                      bool(kwargs.get("ops_lock"))))
        return real(self, *args, **kwargs)

    _NativeEngine.run_block_loop = spy
    try:
        yield calls
    finally:
        _NativeEngine.run_block_loop = real


def blockmod_pass(work: str) -> int:
    """The engine's last per-op features on the card at the main path's
    width (-t 2 -b 16M --iodepth 4) on a 1 GiB file of 64 blocks, each
    run beside its plain twin (the same run without the feature, through
    the fused ring where that is eligible). Returns the fingerprint
    launches.

    (a) -w --verify 7 --verifydirect --gpuids 0, staged and --gpudirect,
        under --gpustream auto: the NOTE names the read-back, the Python
        loop serves every op, 64 D2H copies and the file's bytes; each
        written block was read back and verified on the host. Then a
        --gpuverify read of the file (64 launches).
    (b) -r --verify 7 --gpuverify --opslog F --opsloglock, staged and
        --gpudirect: 64 "read" records, each a whole JSON line, ranks 0
        and 1, the offsets covering the file once, 64 launches; and
        --gpustream on --opslog fails naming the blocker.
    (c) -w -r --verify 7 --gpuverify --gpudirect with --flock range and
        --flock full: bytes, ops, 64 launches, the Python loop.
    (d) without a device, at --iodepth 1: --opslog (the engine writes
        the 64 records), --flock range and --readinline --verify 7, each
        served by the engine's block loop with the feature's argument."""
    t_start = time.monotonic()
    path = os.path.join(work, "blockmod.bin")
    ops_path = os.path.join(work, "blockmod.jsonl")
    json_path = os.path.join(work, "blockmod.json")
    blocks = BLOCKMOD_SIZE // MAIN_BLOCK
    common = ["-t", "2", "-b", f"{MAIN_BLOCK >> 20}M", "--iodepth",
              str(TREE_IODEPTH),
              "-s", f"{BLOCKMOD_SIZE >> 20}M"]
    dev = ["--gpuids", "0"]
    verify = ["--verify", "7"]
    total = 0

    def run(name, args, phases, on_device=True, launches=0, fused=False):
        """One run, checked for its bytes, ops, copies, launches and
        loop; returns ({phase: record}, console output, engine calls)."""
        nonlocal total
        out = _Tee(sys.stdout)
        with contextlib.redirect_stdout(out), engine_calls() as calls:
            recs, got = run_pass(name, args + [path], json_path, phases,
                                 on_device=on_device)
        total += got
        if got != launches:
            fail(f"pass '{name}': {got} fingerprint launches, want "
                 f"{launches}")
        for rec in recs:
            expect(name, rec, BytesLast=BLOCKMOD_SIZE, ops=blocks,
                   TpuStreamFusedOps=blocks if fused else 0,
                   device_ops=blocks if on_device else 0)
        if on_device and calls:
            fail(f"pass '{name}': a device phase called the engine's "
                 f"block loop")
        return {r["Phase"]: r for r in recs}, out.text.getvalue(), calls

    def line(name, rec, twin, loop):
        print(f"  {name}: {loop}, {rec['MiBPerSecLast']} MiB/s against "
              f"the twin's {twin['MiBPerSecLast']} MiB/s "
              f"({rec['MiBPerSecLast'] / twin['MiBPerSecLast']:.3f}x)")

    print(f"blockmod pass (a): -w --verify 7 --verifydirect, "
          f"{BLOCKMOD_SIZE >> 20} MiB")
    note = ("NOTE: fused GPU stream ineligible (--readinline/--verifydirect "
            "inline read-back); using the Python loop")
    for mode, flags in (("staged", []), ("--gpudirect", ["--gpudirect"])):
        twin, _, _ = run(f"-w --verify 7, {mode}",
                         ["-w", *common, *dev, *verify, *flags], ["WRITE"],
                         fused=True)
        recs, out, _ = run(f"-w --verify 7 --verifydirect, {mode}",
                           ["-w", *common, *dev, *verify, "--verifydirect",
                            *flags], ["WRITE"])
        if note not in out:
            fail(f"the --verifydirect write ({mode}) printed no NOTE naming "
                 f"the read-back")
        line(f"--verifydirect write, {mode}", recs["WRITE"], twin["WRITE"],
             loop_taken(recs["WRITE"]))
        run(f"--gpuverify read after the --verifydirect write, {mode}",
            ["-r", *common, *dev, *verify, "--gpuverify", *flags], ["READ"],
            launches=blocks, fused=True)

    print("blockmod pass (b): -r --verify 7 --gpuverify --opslog "
          "--opsloglock")
    for mode, flags in (("staged", []), ("--gpudirect", ["--gpudirect"])):
        read = ["-r", *common, *dev, *verify, "--gpuverify", *flags]
        twin, _, _ = run(f"-r --gpuverify, {mode}", read, ["READ"],
                         launches=blocks, fused=True)
        if os.path.exists(ops_path):
            os.unlink(ops_path)
        recs, out, _ = run(f"-r --gpuverify --opslog, {mode}",
                           read + ["--opslog", ops_path, "--opsloglock"],
                           ["READ"], launches=blocks)
        with open(ops_path) as f:
            text = f.read()
        lines = text.split("\n")
        if lines[-1] != "" or len(lines) != blocks + 1:
            fail(f"--opslog ({mode}): {len(lines) - 1} lines, want {blocks} "
                 f"whole lines")
        ops = [json.loads(x) for x in lines[:-1]]
        offsets = sorted(r["offset"] for r in ops)
        if {r["op_name"] for r in ops} != {"read"} \
                or {r["worker_rank"] for r in ops} != {0, 1} \
                or offsets != [i * MAIN_BLOCK for i in range(blocks)] \
                or {r["length"] for r in ops} != {MAIN_BLOCK} \
                or any(r["is_error"] or not r["is_finished"] for r in ops):
            fail(f"--opslog ({mode}): the records do not cover the file "
                 f"once in read records of ranks 0 and 1")
        line(f"--opslog read, {mode}", recs["READ"], twin["READ"],
             f"{loop_taken(recs['READ'])}, {len(ops)} records")
    failing_run("-r --gpustream on --opslog",
                ["-r", *common, *dev, "--gpustream", "on", "--opslog",
                 ops_path, path], json_path,
                "fused native-stream loop unavailable (--opslog per-op "
                "records)")
    print("  -r --gpustream on --opslog: failed naming the blocker")

    print("blockmod pass (c): -w -r --flock with --gpudirect")
    wr = ["-w", "-r", *common, *dev, *verify, "--gpuverify", "--gpudirect"]
    twin, _, _ = run("-w -r --gpudirect", wr, ["WRITE", "READ"],
                     launches=blocks, fused=True)
    for mode in ("range", "full"):
        recs, _, _ = run(f"-w -r --flock {mode} --gpudirect",
                         wr + ["--flock", mode], ["WRITE", "READ"],
                         launches=blocks)
        for phase in ("WRITE", "READ"):
            line(f"--flock {mode} {phase.lower()}", recs[phase], twin[phase],
                 loop_taken(recs[phase]))

    print("blockmod pass (d): no device, --iodepth 1, the engine's block "
          "loop")
    host = ["-t", "2", "-b", f"{MAIN_BLOCK >> 20}M", "--iodepth", "1",
            "-s", f"{BLOCKMOD_SIZE >> 20}M", *verify]
    twin, _, _ = run("-w -r, no device", ["-w", "-r", *host],
                     ["WRITE", "READ"], on_device=False)
    if os.path.exists(ops_path):
        os.unlink(ops_path)
    cases = (("--opslog", ["-w", "--opslog", ops_path], ["WRITE"],
              (0, False, True, False)),
             ("--flock range", ["-w", "-r", "--flock", "range"],
              ["WRITE", "READ"], (1, False, False, False)),
             ("--readinline", ["-w", "--readinline"], ["WRITE"],
              (0, True, False, False)))
    for name, flags, phases, want in cases:
        recs, _, calls = run(f"{name}, no device", [*flags, *host], phases,
                             on_device=False)
        if not calls or set(calls) != {want}:
            fail(f"'{name}, no device': the engine's block loop got "
                 f"{sorted(set(calls))}, want {want} in every call")
        for phase in phases:
            line(f"{name} {phase.lower()}, no device", recs[phase],
                 twin[phase], f"engine block loop ({len(calls)} calls)")
    with open(ops_path) as f:
        ops = [json.loads(x) for x in f]
    if len(ops) != blocks or {r["op_name"] for r in ops} != {"write"} \
            or sorted(r["offset"] for r in ops) \
            != [i * MAIN_BLOCK for i in range(blocks)]:
        fail(f"--opslog, no device: {len(ops)} records, want {blocks} write "
             f"records covering the file")
    print(f"  --opslog, no device: the engine wrote {len(ops)} records")
    os.unlink(path)
    os.unlink(ops_path)
    secs = time.monotonic() - t_start
    print(f"blockmod pass: {secs:.1f} s, {total} fingerprint launches")
    if secs > BLOCKMOD_LIMIT_S:
        fail(f"the blockmod pass took {secs:.1f} s, over its "
             f"{BLOCKMOD_LIMIT_S} s")
    return total


HOST_LOSF_FILES = 8 * 16 * 64  # -t 8 -n 16 -N 64 of 4 KiB, no device
TREE_LIMIT_S = 90              # the most the tree pass may take
TREE_SHARE = 32 << 20          # --sharesize: -b 16M x 2 dataset threads
TREE_IODEPTH = 4               # the tree runs' --iodepth
#: the tree's two shared files: 32 blocks, and 33 blocks and a short one
TREE_BIG = {"big0": 512 << 20, "big1": (528 << 20) + 4361}
TREE_SMALL_STEP = 4361         # small file i holds i * i * this many bytes


@contextlib.contextmanager
def file_loop_calls():
    """The (op, number of paths) of every call into the native engine's
    per-file loop while the block runs."""
    from elbencho_tpu_torch.utils.native import _NativeEngine
    real = _NativeEngine.run_file_loop
    calls = []

    def spy(self, paths, op, *args, **kwargs):
        calls.append((op, len(paths)))
        return real(self, paths, op, *args, **kwargs)

    _NativeEngine.run_file_loop = spy
    try:
        yield calls
    finally:
        _NativeEngine.run_file_loop = real


def tree_sizes() -> "dict[str, int]":
    """The custom tree of the tree pass: the two shared files and 62 small
    ones from 0 bytes to just under 16 MiB in four subdirectories, most
    of them not a multiple of 4 KiB; about 1.35 GiB in all."""
    sizes = dict(TREE_BIG)
    for i in range(62):
        sizes[f"s/d{i % 4}/f{i}"] = i * i * TREE_SMALL_STEP
    return sizes


def tree_pass(work: str, device_losf_rates: dict) -> int:
    """The engine's per-file loop and the custom trees; returns the
    fingerprint launches. Each run's loop, MiB/s and the pass's wall time
    are printed, and the pass must end within TREE_LIMIT_S.

    (a) The lots-of-small-files run without a device (-d -w --stat -r -F
        -D -t 8 -n 16 -N 64 -s 4K -b 4K --verify 7): the engine's
        per-file loop serves WRITE, STAT, READ and RMFILES (a spy on
        run_file_loop), 8192 entries per file phase, 128 per dir phase,
        the directory empty after RMDIRS; each phase's entries/s beside
        the device LOSF pass's.
    (b) A custom tree at the main path's width: a directory of tree_sizes()
        (sparse files) scanned with --treescan into a tree file, checked
        against the directory; then -w -r --verify 7 --gpuverify --gpuids
        0 -t 2 -b 16M --iodepth 4 --treefile T into an empty bench dir,
        staged and --gpudirect, then -w -r under --treeroundrob and a
        --treerand read of what it wrote (each shared file whole and
        verified), and -F, which leaves only directories. Each run books
        the tree's bytes in WRITE and READ, the sublists' elements as
        entries, one launch per block read, and exactly the blocks of the
        ranges at least two ring-fills long as the fused ring's ops."""
    from elbencho_tpu_torch.toolkits.path_store import PathStore
    t_start = time.monotonic()

    print("tree pass (a): lots of small files without a device")
    bench = os.path.join(work, "losf-host")
    os.makedirs(bench)
    name = "lots of small files, no device"
    with file_loop_calls() as calls:
        recs, _ = run_pass(
            name, ["-d", "-w", "--stat", "-r", "-F", "-D", "-t", "8", "-n",
                   "16", "-N", "64", "-s", "4K", "-b", "4K", "--verify", "7",
                   bench],
            os.path.join(work, "losf-host.json"),
            ["MKDIRS", "WRITE", "STAT", "READ", "RMFILES", "RMDIRS"],
            on_device=False)
    served = {op for op, _ in calls}
    if served != {"write", "stat", "read", "unlink"}:
        fail(f"pass '{name}': the engine's per-file loop served {served}, "
             f"want write, stat, read and unlink")
    for rec in recs:
        want = 8 * 16 if rec["Phase"] in ("MKDIRS", "RMDIRS") \
            else HOST_LOSF_FILES
        expect(name, rec, EntriesLast=want)
    if os.listdir(bench):
        fail(f"pass '{name}': the directory is not empty after RMDIRS")
    print(f"  per-file loop: {len(calls)} engine calls")
    for rec in recs:
        print(f"  {rec['Phase']:<8} {rec['EntriesPerSecLast']} entries/s "
              f"without a device, {device_losf_rates[rec['Phase']]} with "
              f"--gpuids 0 --gpuverify (the device LOSF pass, -N "
              f"{LOSF_PER_DIR})")

    print("tree pass (b): a custom tree at -t 2 -b 16M --iodepth 4")
    src = os.path.join(work, "tree-src")
    sizes = tree_sizes()
    for rel, size in sizes.items():
        path = os.path.join(src, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.truncate(size)  # sparse: the scan reads sizes only
    tree_file = os.path.join(work, "tree.txt")
    rc, _ = run_cli(["--treescan", src, "--treefile", tree_file],
                    os.path.join(work, "treescan.json"))
    if rc != 0:
        fail(f"--treescan exited {rc}")
    scanned, scanned_dirs = PathStore(), PathStore()
    scanned.load_files_from_file(tree_file)
    with open(tree_file) as f:
        scanned_dirs.load_dirs_from_text(f.read())
    want_dirs = 1 + 4  # s, s/d0 .. s/d3
    total = scanned.total_bytes
    if scanned.num_paths != len(sizes) or total != sum(sizes.values()) \
            or scanned_dirs.num_paths != want_dirs:
        fail(f"--treescan wrote {scanned.num_paths} files of {total} bytes "
             f"and {scanned_dirs.num_paths} dirs, want {len(sizes)} files "
             f"of {sum(sizes.values())} bytes and {want_dirs} dirs")
    print(f"  --treescan: {scanned.num_paths} files, {total} bytes, "
          f"{want_dirs} dirs")
    shutil.rmtree(src)

    def shares(round_robin: bool, rand: bool) -> "tuple[int, int]":
        """The elements of both workers' sublists (the port's PathStore,
        as the workers split the tree) and the fused ring's ops: the
        blocks of each range that holds at least two ring-fills."""
        store = PathStore(block_size=MAIN_BLOCK)
        store.load_files_from_file(tree_file)
        if rand:
            store.random_shuffle(seed=42)
        else:
            store.sort_by_path_len()
        non_shared, shared = store.split_by_share_size(TREE_SHARE)
        sub = shared.get_worker_sublist_shared_round_robin if round_robin \
            else shared.get_worker_sublist_shared
        elems = [e for r in range(2)
                 for e in (non_shared.get_worker_sublist_non_shared(r, 2)
                           .elems + sub(r, 2).elems)]
        if sum(e.range_len for e in elems) != total:
            fail(f"the workers' shares of the tree hold "
                 f"{sum(e.range_len for e in elems)} bytes, want {total}")
        ring = sum(-(-e.range_len // MAIN_BLOCK) for e in elems
                   if e.range_len // MAIN_BLOCK >= 2 * TREE_IODEPTH)
        return len(elems), ring

    blocks = sum((n + MAIN_BLOCK - 1) // MAIN_BLOCK for n in sizes.values())
    tree_bench = os.path.join(work, "tree")
    os.makedirs(tree_bench)
    common = ["-t", "2", "-b", f"{MAIN_BLOCK >> 20}M", "--iodepth",
              str(TREE_IODEPTH),
              "--verify", "7", "--gpuverify", "--gpuids", "0",
              "--treefile", tree_file]
    launches = 0
    for label, flags, phases in (
            ("staged", [], ["-w", "-r"]),
            ("--gpudirect", ["--gpudirect"], ["-w", "-r"]),
            ("--treeroundrob --gpudirect", ["--treeroundrob", "--gpudirect"],
             ["-w", "-r"]),
            ("--treerand --gpudirect", ["--treerand", "--gpudirect"],
             ["-r"])):
        name = f"custom tree {' '.join(phases)}, {label}"
        want_phases = [{"-w": "WRITE", "-r": "READ"}[p] for p in phases]
        t0 = time.monotonic()
        with file_loop_calls() as calls:
            recs, got = run_pass(name, [*phases, *common, *flags,
                                        tree_bench],
                                 os.path.join(work, "tree.json"),
                                 want_phases)
        secs = time.monotonic() - t0
        launches += got
        if calls:
            fail(f"pass '{name}': a device phase called the engine's "
                 f"per-file loop")
        want_entries, want_ring = shares("--treeroundrob" in flags,
                                         "--treerand" in flags)
        for rec in recs:
            expect(name, rec, BytesLast=total, TpuHbmBytes=total,
                   EntriesLast=want_entries, TpuStreamFusedOps=want_ring,
                   ops=blocks, device_ops=blocks)
            print(f"  {name} {rec['Phase']}: {loop_taken(rec)}, "
                  f"{rec['MiBPerSecLast']} MiB/s")
        if got != blocks:
            fail(f"pass '{name}': {got} fingerprint launches, want {blocks} "
                 f"(one per block read)")
        print(f"  {name}: {secs:.1f} s")
        for rel, size in TREE_BIG.items():
            got_size = os.path.getsize(os.path.join(tree_bench, rel))
            if got_size != size:
                fail(f"pass '{name}': shared file {rel} is {got_size} "
                     f"bytes, want {size}")

    name = "custom tree -F"
    recs, _ = run_pass(name, ["-F", *common, tree_bench],
                       os.path.join(work, "tree.json"), ["RMFILES"])
    expect(name, recs[0], EntriesLast=len(sizes))
    left = [os.path.join(d, f) for d, _, fs in os.walk(tree_bench)
            for f in fs]
    if left:
        fail(f"pass '{name}' left files behind: {left[:5]}")
    shutil.rmtree(tree_bench)
    os.unlink(tree_file)
    secs = time.monotonic() - t_start
    print(f"tree pass: {secs:.1f} s, {launches} fingerprint launches")
    if secs > TREE_LIMIT_S:
        fail(f"the tree pass took {secs:.1f} s, over its {TREE_LIMIT_S} s")
    return launches


MMAP_SIZE = 2 << 30            # -s 2g of the mmap pass
MMAP_LIMIT_S = 90              # the most the mmap pass may take
MMAP_DIR_FILES = 64            # -N of its dir-mode run (-n 1, 16 MiB each)


@contextlib.contextmanager
def mmap_loop_calls():
    """The number of blocks of every call into the native engine's mmap
    loop while the block runs."""
    from elbencho_tpu_torch.utils.native import _NativeEngine
    real = _NativeEngine.run_mmap_loop
    calls = []

    def spy(self, map_addr, offsets, *args, **kwargs):
        calls.append(len(offsets))
        return real(self, map_addr, offsets, *args, **kwargs)

    _NativeEngine.run_mmap_loop = spy
    try:
        yield calls
    finally:
        _NativeEngine.run_mmap_loop = real


@contextlib.contextmanager
def staging_slabs():
    """(hugepage_backed, registered and seen as pinned) of every staging
    pool whose I/O slots are page-locked while the block runs."""
    import torch
    from elbencho_tpu_torch.utils.staging_pool import StagingPool
    real = StagingPool.register_slots
    slabs = []

    def spy(self):
        real(self)
        slot = torch.frombuffer(self.views[0], dtype=torch.uint8)
        slabs.append((self.hugepage_backed,
                      self.registered and slot.is_pinned()))

    StagingPool.register_slots = spy
    try:
        yield slabs
    finally:
        StagingPool.register_slots = real


def mmap_pass(work: str) -> int:
    """Memory-mapped I/O at the main path's width (-t 2 -b 16M --iodepth
    4) on a 2 GiB file of 128 blocks; returns the fingerprint launches.
    Each run's loop and MiB/s and the pass's wall time are printed, and
    the pass must end within MMAP_LIMIT_S.

    (a) -w -r --mmap --verify 7 --gpuverify --gpuids 0, staged and
        --gpudirect: the Python memcpy loop serves every op (no fused
        ring op, no engine mmap call), 128 device copies and one launch
        per block read; beside each, its --gpustream off twin (the pread
        Python loop) on the same file.
    (b) the same write and read without a device: the engine's mmap loop
        serves every op (a spy on run_mmap_loop), beside its twin
        without --mmap (the engine's block loop).
    (c) dir mode, -d -w -r -F -D -n 1 -N 64 -s 16M -b 16M --mmap --verify
        7 --gpuverify --gpuids 0 --madv seq,willneed --fadv seq: 128
        entries, 128 launches, the directory empty at the end.
    (d) --madv hugepage and --madv nohugepage --gpudirect reads of the
        file: the staging slab's hugepage_backed is printed, and the
        slab registered with cudaHostRegister must be seen as pinned.
    (e) --gpustream on --mmap is refused with the JAX package's text."""
    t_start = time.monotonic()
    path = os.path.join(work, "mmap.bin")
    json_path = os.path.join(work, "mmap.json")
    blocks = MMAP_SIZE // MAIN_BLOCK
    common = ["-t", "2", "-b", f"{MAIN_BLOCK >> 20}M", "--iodepth", "4",
              "-s", f"{MMAP_SIZE >> 20}M"]
    verify = ["--verify", "7"]
    total = 0

    def run(name, args, phases, on_device=True, mmap_calls=0,
            launches=None):
        """One run, checked for its bytes, ops, copies, launches and
        loop; returns its records by phase."""
        nonlocal total
        with mmap_loop_calls() as calls:
            recs, got = run_pass(name, args, json_path, phases,
                                 on_device=on_device)
        total += got
        want = launches if launches is not None \
            else (blocks if on_device and "--gpuverify" in args else 0)
        if got != want:
            fail(f"pass '{name}': {got} fingerprint launches, want {want}")
        if sum(calls) != mmap_calls:
            fail(f"pass '{name}': the engine's mmap loop served "
                 f"{sum(calls)} blocks, want {mmap_calls}")
        return {r["Phase"]: r for r in recs}

    def check(name, rec, on_device=True):
        expect(name, rec, BytesLast=MMAP_SIZE, ops=blocks,
               TpuStreamFusedOps=0,
               TpuHbmBytes=MMAP_SIZE if on_device else 0,
               device_ops=blocks if on_device else 0)

    def line(name, rec, twin, loop, twin_loop):
        print(f"  {name} {rec['Phase']}: {loop}, device "
              f"{rec['TpuHbmMiBPerSec']} MiB/s, storage "
              f"{rec['MiBPerSecLast']} MiB/s; {twin_loop} twin: device "
              f"{twin['TpuHbmMiBPerSec']} MiB/s, storage "
              f"{twin['MiBPerSecLast']} MiB/s")

    print(f"mmap pass (a): -w -r --mmap --verify 7 --gpuverify, "
          f"{MMAP_SIZE >> 20} MiB")
    for mode, flags in (("staged", []), ("--gpudirect", ["--gpudirect"])):
        dev = ["--gpuids", "0", "--gpuverify", *flags]
        name = f"-w -r --mmap, {mode}"
        recs = run(name, ["-w", "-r", *common, *verify, *dev, "--mmap",
                          path], ["WRITE", "READ"])
        twins = run(f"-w -r, {mode}, --gpustream off twin",
                    ["-w", "-r", *common, *verify, *dev, "--gpustream",
                     "off", path], ["WRITE", "READ"])
        for phase, rec in recs.items():
            check(name, rec)
            check(name, twins[phase])
            if flags and phase == "READ" and rec["TpuH2dDirectOps"] != blocks:
                fail(f"pass '{name}': {rec['TpuH2dDirectOps']} direct "
                     f"copies, want {blocks}")
            line(name, rec, twins[phase], "Python memcpy loop",
                 "pread Python loop")

    print("mmap pass (b): the same without a device")
    name = "-w -r --mmap, no device"
    recs = run(name, ["-w", "-r", *common, *verify, "--mmap", path],
               ["WRITE", "READ"], on_device=False, mmap_calls=2 * blocks)
    twins = run("-w -r, no device, block-loop twin",
                ["-w", "-r", *common, *verify, path], ["WRITE", "READ"],
                on_device=False)
    for phase, rec in recs.items():
        check(name, rec, on_device=False)
        check(name, twins[phase], on_device=False)
        line(name, rec, twins[phase], "the engine's mmap loop",
             "the engine's block loop")

    print("mmap pass (c): dir mode with --madv and --fadv")
    bench = os.path.join(work, "mmap-dir")
    os.makedirs(bench)
    name = "dir mode --mmap --madv seq,willneed --fadv seq"
    recs = run(name, ["-d", "-w", "-r", "-F", "-D", "-t", "2", "-n", "1",
                      "-N", str(MMAP_DIR_FILES), "-s", "16M", "-b", "16M",
                      *verify, "--gpuids", "0", "--gpuverify", "--mmap",
                      "--madv", "seq,willneed", "--fadv", "seq", bench],
               ["MKDIRS", "WRITE", "READ", "RMFILES", "RMDIRS"],
               launches=2 * MMAP_DIR_FILES)
    for phase in ("WRITE", "READ"):
        expect(name, recs[phase], EntriesLast=2 * MMAP_DIR_FILES,
               BytesLast=2 * MMAP_DIR_FILES * MAIN_BLOCK,
               TpuHbmBytes=2 * MMAP_DIR_FILES * MAIN_BLOCK,
               TpuStreamFusedOps=0, device_ops=2 * MMAP_DIR_FILES)
        print(f"  {name} {phase}: device "
              f"{recs[phase]['TpuHbmMiBPerSec']} MiB/s, "
              f"{recs[phase]['EntriesPerSecLast']} entries/s")
    if os.listdir(bench):
        fail(f"pass '{name}': the directory is not empty after RMDIRS")
    os.rmdir(bench)

    print("mmap pass (d): --madv hugepage and nohugepage reads")
    for advice in ("hugepage", "nohugepage"):
        name = f"-r --mmap --madv {advice} --gpudirect"
        with staging_slabs() as slabs:
            (rec,) = run(name, ["-r", *common, "--gpuids", "0",
                                "--gpudirect", "--mmap", "--madv", advice,
                                path], ["READ"]).values()
        check(name, rec)
        if len(slabs) != 2 or not all(pinned for _, pinned in slabs):
            fail(f"pass '{name}': staging slabs {slabs}, want 2 registered "
                 f"and seen as pinned")
        if advice == "nohugepage" and any(huge for huge, _ in slabs):
            fail(f"pass '{name}': a slab is hugetlb-backed under "
                 f"nohugepage")
        print(f"  {name}: device {rec['TpuHbmMiBPerSec']} MiB/s; staging "
              f"slabs hugepage_backed {[h for h, _ in slabs]}, pinned")

    print("mmap pass (e): --gpustream on --mmap")
    err = _Tee()
    with contextlib.redirect_stderr(err):
        rc, _ = run_cli(["-r", *common, "--gpuids", "0", "--gpustream",
                         "on", "--mmap", path], json_path)
    refusal = ("--gpustream on requires the POSIX block I/O path "
               "(incompatible with --mmap and object/netbench modes)")
    if rc == 0 or refusal not in err.text.getvalue():
        fail(f"--gpustream on --mmap exited {rc} without the refusal "
             f"'{refusal}'")
    print(f"  refused as it must (rc {rc})")
    os.unlink(path)
    secs = time.monotonic() - t_start
    print(f"mmap pass: {secs:.1f} s, {total} fingerprint launches")
    if secs > MMAP_LIMIT_S:
        fail(f"the mmap pass took {secs:.1f} s, over its {MMAP_LIMIT_S} s")
    return total


ACCESS_SIZE = 2 << 30           # -s 2g of the direct I/O and pattern pass
ACCESS_LIMIT_S = 90             # the most the access pass may take
ACCESS_RAND_AMOUNT = 512 << 20  # --randamount of its random reads
ACCESS_WINDOW = 256 << 20       # --shufflewindow of its shuffled reads
ACCESS_PATH_SIZE = 256 << 20    # -s of each of the four f{1..4} files
RAND_ALGOS = ("strong", "balanced_single", "balanced", "fast")


def o_direct_probe(directory: str) -> dict:
    """What O_DIRECT does in `directory`: whether an open with it works,
    whether fcntl(F_GETFL) keeps the flag, whether an aligned 4 KiB
    preadv works, and whether one into a buffer one byte off alignment
    is refused (a file system that serves it from the page cache takes
    it)."""
    import fcntl
    import mmap
    path = os.path.join(directory, "o_direct.probe")
    with open(path, "wb") as f:
        f.write(bytes(8192))
    out = {"opens": False, "getfl_keeps": False, "aligned_read": False,
           "misaligned_refused": False, "error": ""}
    try:
        fd = os.open(path, os.O_RDONLY | os.O_DIRECT)
    except OSError as err:
        out["error"] = f"{type(err).__name__}: {err}"
        os.unlink(path)
        return out
    buf = mmap.mmap(-1, 16384)
    try:
        out["opens"] = True
        out["getfl_keeps"] = bool(fcntl.fcntl(fd, fcntl.F_GETFL)
                                  & os.O_DIRECT)
        try:
            out["aligned_read"] = os.preadv(
                fd, [memoryview(buf)[:4096]], 0) == 4096
        except OSError as err:
            out["error"] = f"aligned read: {err}"
        try:
            os.preadv(fd, [memoryview(buf)[1:4097]], 0)
        except OSError as err:
            out["misaligned_refused"] = err.errno == errno.EINVAL
    finally:
        os.close(fd)
        buf.close()
        os.unlink(path)
    return out


@contextlib.contextmanager
def ring_fd_flags():
    """The O_DIRECT bit of each fd the fused ring opens over, read with
    fcntl(F_GETFL) as each ring opens, while the block runs."""
    import fcntl
    from elbencho_tpu_torch.utils.native import _NativeEngine
    real = _NativeEngine.open_stream
    flags = []

    def spy(self, fds, *args, **kwargs):
        flags.extend(bool(fcntl.fcntl(fd, fcntl.F_GETFL) & os.O_DIRECT)
                     for fd in fds)
        return real(self, fds, *args, **kwargs)

    _NativeEngine.open_stream = spy
    try:
        yield flags
    finally:
        _NativeEngine.open_stream = real


@contextlib.contextmanager
def worker_offsets():
    """Each file-mode offset generator a worker makes while the block
    runs, drained (then reset for the phase): {rank: [(offset, length),
    ...]}."""
    from elbencho_tpu_torch.workers.local_worker import LocalWorker
    real = LocalWorker._make_file_mode_offset_gen
    seqs: "dict[int, list]" = {}

    def spy(self, *args, **kwargs):
        gen = real(self, *args, **kwargs)
        if gen is not None:
            seqs.setdefault(self.rank, []).extend(gen)
            gen.reset()
        return gen

    LocalWorker._make_file_mode_offset_gen = spy
    try:
        yield seqs
    finally:
        LocalWorker._make_file_mode_offset_gen = real


@contextlib.contextmanager
def path_opens(path: str):
    """The flags of every os.open of `path` while the block runs."""
    real = os.open
    flags = []

    def spy(p, fl, *args, **kwargs):
        if os.fspath(p) == path:
            flags.append(fl)
        return real(p, fl, *args, **kwargs)

    os.open = spy
    try:
        yield flags
    finally:
        os.open = real


def refused(name: str, args: "list[str]", json_path: str,
            text: str) -> None:
    """Fail unless the CLI refuses `args` with `text` on stderr."""
    err = _Tee()
    with contextlib.redirect_stderr(err):
        rc, _ = run_cli(args, json_path)
    if rc == 0 or text not in err.text.getvalue():
        fail(f"{name} exited {rc} without the refusal '{text}'")
    print(f"  {name}: refused as it must (rc {rc}): {text}")


def access_pass(work: str) -> int:
    """Direct I/O and the access patterns at the main path's width (-t 2
    -b 16M --iodepth 4 --gpuids 0) on a 2 GiB file of 128 blocks;
    returns the fingerprint launches. Each run's loop and MiB/s and the
    pass's wall time are printed, and the pass must end within
    ACCESS_LIMIT_S.

    (0) An O_DIRECT probe of the work directory, then of the temporary
        directory: the open, fcntl(F_GETFL), an aligned and a misaligned
        preadv. The first directory that opens with O_DIRECT holds the
        runs; where none does, a --direct phase must fail with the JAX
        package's text, and the runs go on without --direct.
    (a) The main path under --direct through the fused ring, staged and
        --gpudirect, each beside its buffered twin; a --direct
        --gpudirect --verify 7 --gpuverify read (128 launches); the
        ring's fds must carry O_DIRECT where F_GETFL reports it.
    (b) --verify 7 --gpuverify reads under each pattern: --rand
        --randamount 512M for each --randalgo, --backward, --strided and
        --shufflewindow 256M: one launch per block read, and each of the
        last three reads every block once; --rand --norandalign (without
        --direct) reads its bytes, and with --verify 7 --gpuverify fails
        on a block at an offset that is not a multiple of 8, as the JAX
        package does; then the shuffled read and its sequential twin
        without verify, both rates printed.
    (c) -w -r over work/f{1..4}, four 256 MiB files, against --nopathexp
        on a literal name with braces.
    (d) --nofdsharing: one open of the file per worker, against one.
    (e) The refusals of --mmap --direct and --shufflewindow --rand."""
    t_start = time.monotonic()
    blocks = ACCESS_SIZE // MAIN_BLOCK
    bs = f"{MAIN_BLOCK >> 20}M"
    common = ["-t", "2", "-b", bs, "--iodepth", "4", "--gpuids", "0"]
    verify = ["--verify", "7", "--gpuverify"]
    total = 0

    print("access pass (0): O_DIRECT probe")
    tmp_root = tempfile.gettempdir()
    where, probe = None, None
    for cand in (work, tmp_root):
        if cand != work and shutil.disk_usage(cand).free \
                < ACCESS_SIZE + (1 << 30):
            print(f"  {cand}: too little space for the pass's file")
            continue
        probe = o_direct_probe(cand)
        print(f"  {cand}: {json.dumps(probe)}")
        if probe["opens"] and probe["aligned_read"]:
            where = cand
            break
    direct = ["--direct"] if where else []
    if where is None:
        where = work
        name = "-r --direct on a file system that refuses O_DIRECT"
        path = os.path.join(where, "nodirect.bin")
        with open(path, "wb") as f:
            f.truncate(ACCESS_SIZE)
        refused(name, ["-r", *common, "-s", f"{ACCESS_SIZE >> 20}M",
                       "--direct", path], os.path.join(work, "access.json"),
                "unable to open benchmark path")
        os.unlink(path)
        print("  the card's file systems refuse O_DIRECT; the runs below "
              "go without --direct")
    elif not probe["misaligned_refused"]:
        print(f"  {where} takes a misaligned O_DIRECT read: page-cache "
              f"reads cannot be told apart there, so the runs below are "
              f"held to their bytes and checks, not to a speed")
    bench = os.path.join(where, "access")
    os.makedirs(bench, exist_ok=True)
    path = os.path.join(bench, "access.bin")
    json_path = os.path.join(work, "access.json")
    size = ["-s", f"{ACCESS_SIZE >> 20}M"]

    def run(name, args, phases=("READ",), launches=0, ops=blocks,
            nbytes=ACCESS_SIZE):
        nonlocal total
        recs, got = run_pass(name, args, json_path, list(phases))
        total += got
        if got != launches:
            fail(f"pass '{name}': {got} fingerprint launches, want "
                 f"{launches}")
        for rec in recs:
            expect(name, rec, BytesLast=nbytes, TpuHbmBytes=nbytes, ops=ops,
                   device_ops=ops)
        return recs[-1]

    try:
        run("write the access file", ["-w", *common, *size, "--verify", "7",
                                      *direct, path], phases=("WRITE",))

        print(f"access pass (a): the main path {' '.join(direct) or ''} "
              f"through the fused ring")
        for mode, flags in (("staged", []), ("--gpudirect",
                                             ["--gpudirect"])):
            name = f"-r {' '.join(direct)} {mode}"
            with ring_fd_flags() as fd_flags:
                rec = run(name, ["-r", *common, *flags, *direct,
                                 "--gpustream", "on", path])
            twin = run(f"{name}, buffered twin",
                       ["-r", *common, *flags, "--gpustream", "on", path])
            expect(name, rec, TpuStreamFusedOps=blocks)
            if direct and probe["getfl_keeps"] and not all(fd_flags):
                fail(f"pass '{name}': the ring's fds {fd_flags} lack "
                     f"O_DIRECT")
            print(f"  {name}: device {rec['TpuHbmMiBPerSec']} MiB/s, "
                  f"storage {rec['MiBPerSecLast']} MiB/s; buffered twin: "
                  f"device {twin['TpuHbmMiBPerSec']} MiB/s; the ring's fds "
                  f"carry O_DIRECT per F_GETFL: {fd_flags}")
        name = f"-r {' '.join(direct)} --gpudirect {' '.join(verify)}"
        rec = run(name, ["-r", *common, *verify, "--gpudirect", *direct,
                         path], launches=blocks)
        print(f"  {name}: device {rec['TpuHbmMiBPerSec']} MiB/s, "
              f"{loop_taken(rec)}")

        print("access pass (b): --gpuverify reads under each pattern")
        rand_blocks = ACCESS_RAND_AMOUNT // MAIN_BLOCK
        rand = ["--rand", "--randamount", f"{ACCESS_RAND_AMOUNT >> 20}M"]
        patterns = [(f"--rand --randalgo {algo}",
                     [*rand, "--randalgo", algo, *direct], rand_blocks)
                    for algo in RAND_ALGOS]
        for name, flags in (("--backward", ["--backward"]),
                            ("--strided", ["--strided"]),
                            (f"--shufflewindow {ACCESS_WINDOW >> 20}M",
                             ["--shufflewindow",
                              f"{ACCESS_WINDOW >> 20}M"])):
            patterns.append((name, [*flags, *direct], blocks))
        for name, flags, n in patterns:
            with worker_offsets() as seqs:
                rec = run(name, ["-r", *common, *size, *verify, *flags,
                                 path], launches=n, ops=n,
                          nbytes=n * MAIN_BLOCK)
            every = sorted(b for seq in seqs.values() for b in seq)
            if "--rand" not in flags and every != [
                    (i * MAIN_BLOCK, MAIN_BLOCK) for i in range(blocks)]:
                fail(f"pass '{name}': the workers' offsets do not read "
                     f"each block once")
            print(f"  {name}: device {rec['TpuHbmMiBPerSec']} MiB/s, "
                  f"{n} blocks, {n} launches, {loop_taken(rec)}")
        # --norandalign: the bytes without verify, then the quirk that
        # both packages keep: a verified read fails on the first block at
        # an offset that is not a multiple of 8, which the pattern laid
        # out from the block's own offset does not match
        name = "--rand --norandalign"
        rec = run(name, ["-r", *common, *size, *rand, "--norandalign",
                         path], ops=rand_blocks,
                  nbytes=rand_blocks * MAIN_BLOCK)
        print(f"  {name}: device {rec['TpuHbmMiBPerSec']} MiB/s, "
              f"{rand_blocks} blocks, {loop_taken(rec)}")
        from elbencho_tpu_torch.ops.verify import fingerprint_u32
        fingerprint_u32.launches.reset()
        text = failing_run(f"{name} {' '.join(verify)}",
                           ["-r", *common, *size, *rand, "--norandalign",
                            *verify, path], json_path,
                           "on-device integrity check failed for block")
        got = fingerprint_u32.launches.count
        total += got
        bad = [int(m) for m in re.findall(r"block at offset (\d+)", text)]
        if not got or not bad or any(off % 8 == 0 for off in bad):
            fail(f"pass '{name} --verify': {got} launches, failed blocks "
                 f"at {bad}; want a block at an offset that is not a "
                 f"multiple of 8")
        print(f"  {name} {' '.join(verify)}: failed as the JAX package "
              f"fails it, {got} launches, first failed blocks at offsets "
              f"{sorted(set(bad))} (none a multiple of 8)")
        shuffled = run("--shufflewindow, no verify",
                       ["-r", *common, *size, "--shufflewindow",
                        f"{ACCESS_WINDOW >> 20}M", *direct, path])
        sequential = run("sequential twin, no verify",
                         ["-r", *common, *size, *direct, path])
        print(f"  --shufflewindow {ACCESS_WINDOW >> 20}M: device "
              f"{shuffled['TpuHbmMiBPerSec']} MiB/s against the sequential "
              f"twin's {sequential['TpuHbmMiBPerSec']} MiB/s "
              f"({shuffled['TpuHbmMiBPerSec'] / max(sequential['TpuHbmMiBPerSec'], 1e-9):.4f}x)")

        print("access pass (c): {N..M} path expansion and --nopathexp")
        n_path = ACCESS_PATH_SIZE // MAIN_BLOCK
        name = "-w -r f{1..4}"
        run(name, ["-w", "-r", *common, "-s", f"{ACCESS_PATH_SIZE >> 20}M",
                   *verify, *direct, os.path.join(bench, "f{1..4}")],
            phases=("WRITE", "READ"), launches=4 * n_path, ops=4 * n_path,
            nbytes=4 * ACCESS_PATH_SIZE)
        literal = os.path.join(bench, "lit{1..2}")
        run("-w --nopathexp lit{1..2}",
            ["-w", *common, "-s", f"{ACCESS_PATH_SIZE >> 20}M",
             "--nopathexp", *direct, literal], phases=("WRITE",),
            ops=n_path, nbytes=ACCESS_PATH_SIZE)
        names = sorted(os.listdir(bench))
        if not {"f1", "f2", "f3", "f4", "lit{1..2}"} <= set(names) \
                or "f{1..4}" in names:
            fail(f"the expansion pass left {names}")
        print(f"  f{{1..4}} made four files and the literal name one: "
              f"{names}")

        print("access pass (d): --nofdsharing")
        for flags, want in (([], 1), (["--nofdsharing"], 2)):
            name = f"-r {' '.join(flags) or '(shared fds)'}"
            with path_opens(path) as opened:
                rec = run(name, ["-r", *common, *size, *flags, *direct,
                                 path])
            if len(opened) != want or (direct and not all(
                    f & os.O_DIRECT for f in opened)):
                fail(f"pass '{name}': {len(opened)} opens of the file "
                     f"(flags {opened}), want {want} with O_DIRECT "
                     f"{bool(direct)}")
            print(f"  {name}: {len(opened)} open(s) of the file, device "
                  f"{rec['TpuHbmMiBPerSec']} MiB/s")

        print("access pass (e): the refusals")
        refused("--mmap --direct", ["-r", *common, *size, "--mmap",
                                    "--direct", path],
                json_path, "--mmap and --direct are incompatible")
        refused("--shufflewindow --rand",
                ["-r", *common, *size, "--shufflewindow",
                 f"{ACCESS_WINDOW >> 20}M", "--rand", path], json_path,
                "--shufflewindow drives its own offset permutation")
    finally:
        shutil.rmtree(bench, ignore_errors=True)
    secs = time.monotonic() - t_start
    print(f"access pass: {secs:.1f} s, {total} fingerprint launches")
    if secs > ACCESS_LIMIT_S:
        fail(f"the access pass took {secs:.1f} s, over its "
             f"{ACCESS_LIMIT_S} s")
    return total


LIFECYCLE_LIMIT_S = 90          # the most the lifecycle pass may take
LIFECYCLE_FILES = 16            # -N: -t 2 x -n 1 x 16 files of 64 MiB, 2 GiB
LIFECYCLE_FILE_SIZE = 64 << 20  # -s of its dir-mode files
LIFECYCLE_LONG = 512 << 20      # the file the --trunctosize write cuts...
LIFECYCLE_SHORT = 256 << 20     # ...to this -s
DROP_CACHES = "/proc/sys/vm/drop_caches"

#: the CLI in a child process with open() of DROP_CACHES patched: the
#: strings written there are recorded and printed, never written
_DROP_CACHES_CHILD = (
    "import builtins, io, json, os, sys\n"
    "real_open = builtins.open\n"
    "written = []\n"
    "class Sink(io.StringIO):\n"
    "    def close(self):\n"
    "        if not self.closed:\n"
    "            written.append(self.getvalue())\n"
    "        super().close()\n"
    "def spy(file, *args, **kwargs):\n"
    "    if isinstance(file, (str, os.PathLike)) \\\n"
    f"            and os.fspath(file) == {DROP_CACHES!r}:\n"
    "        return Sink()\n"
    "    return real_open(file, *args, **kwargs)\n"
    "builtins.open = spy\n"
    "from elbencho_tpu_torch.cli import main\n"
    "rc = main(sys.argv[1:])\n"
    "print('DROP_CACHES_WRITES', json.dumps(written), flush=True)\n"
    "sys.exit(rc)\n")


def fallocate_probe(directory: str, size: int) -> dict:
    """What posix_fallocate does on a new file of `size` bytes in
    `directory`: whether it works (glibc writes each block where the
    file system refuses fallocate), its time, and the file's size and
    allocated bytes after it."""
    path = os.path.join(directory, "fallocate.probe")
    out = {"bytes": size, "ok": False, "error": "", "ms": 0.0, "size": 0,
           "allocated": 0}
    fd = os.open(path, os.O_CREAT | os.O_WRONLY | os.O_TRUNC, 0o644)
    try:
        t0 = time.perf_counter()
        try:
            os.posix_fallocate(fd, 0, size)
            out["ok"] = True
        except OSError as err:
            out["error"] = f"{type(err).__name__}: {err}"
        out["ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        st = os.fstat(fd)
        out["size"], out["allocated"] = st.st_size, st.st_blocks * 512
    finally:
        os.close(fd)
        os.unlink(path)
    return out


@contextlib.contextmanager
def lifecycle_calls(root: str):
    """The fstat calls on files under `root`, its posix_fallocate calls
    and its opens with O_TRUNC while the block runs."""
    real_fstat, real_falloc, real_open = os.fstat, os.posix_fallocate, \
        os.open
    calls = {"fstat": 0, "fallocate": [], "o_trunc": 0}

    def fstat(fd, *args, **kwargs):
        if isinstance(fd, int):
            with contextlib.suppress(OSError):
                if os.readlink(f"/proc/self/fd/{fd}").startswith(root):
                    calls["fstat"] += 1
        return real_fstat(fd, *args, **kwargs)

    def fallocate(fd, offset, length):
        calls["fallocate"].append((offset, length))
        return real_falloc(fd, offset, length)

    def open_spy(path, flags, *args, **kwargs):
        if os.fspath(path).startswith(root) and flags & os.O_TRUNC:
            calls["o_trunc"] += 1
        return real_open(path, flags, *args, **kwargs)

    os.fstat, os.posix_fallocate, os.open = fstat, fallocate, open_spy
    try:
        yield calls
    finally:
        os.fstat, os.posix_fallocate, os.open = real_fstat, real_falloc, \
            real_open


def lifecycle_pass(work: str) -> int:
    """The file-lifecycle flags at the main path's width (-t 2 -b 16M
    --iodepth 4 --gpuids 0); returns the fingerprint launches. Each run's
    device MiB/s, the SYNC phases' elapsed times and the pass's wall
    time are printed, and the pass must end within LIFECYCLE_LIMIT_S.

    (0) A posix_fallocate probe of the work directory (1 MiB and one
        64 MiB file, printed). Where it fails, a --preallocfile write
        must fail with the probe's error, as the JAX package's does, and
        the runs go on without --preallocfile.
    (a) A dir-mode write of 2 GiB (-n 1 -N 16 -s 64M, 32 files) with
        --trunc --preallocfile --statinline --sync --verify 7, staged and
        --gpudirect, each followed by a --statinline --verify 7
        --gpuverify read (128 launches each): a SYNC before the first
        phase and after each, one fstat per file and phase, one
        posix_fallocate of 64 MiB and one O_TRUNC open per written file,
        every file 64 MiB after the write.
    (b) File mode: a --trunctosize write of 256 MiB over a 512 MiB file,
        which must leave it exactly 256 MiB long.
    (c) RMFILES of the tree with two files missing: without --nodelerr
        it fails naming the missing file; with it, and -D, it passes and
        the tree is gone.
    (d) --gpuprofile reads of the 256 MiB file at --log 1 and --log 0:
        the trace path is printed at 1 only.
    (e) -r --sync --dropcaches in a child process whose open() of
        /proc/sys/vm/drop_caches is patched: two DROPCACHE phases of one
        entry each, "3" written twice into the spy, nothing into the
        file."""
    t_start = time.monotonic()
    bs = f"{MAIN_BLOCK >> 20}M"
    common = ["-t", "2", "-b", bs, "--iodepth", "4", "--gpuids", "0"]
    files = 2 * LIFECYCLE_FILES
    blocks = files * LIFECYCLE_FILE_SIZE // MAIN_BLOCK
    bench = os.path.join(work, "lifecycle")
    os.makedirs(bench, exist_ok=True)
    json_path = os.path.join(work, "lifecycle.json")
    layout = ["-n", "1", "-N", str(LIFECYCLE_FILES), "-s",
              f"{LIFECYCLE_FILE_SIZE >> 20}M"]
    total = 0

    def sync_ms(recs) -> str:
        return ", ".join(f"{r['ElapsedUSecLast'] / 1e3:.3f}" for r in recs
                         if r["Phase"] == "SYNC")

    print("lifecycle pass (0): posix_fallocate probe")
    probes = [fallocate_probe(work, size)
              for size in (1 << 20, LIFECYCLE_FILE_SIZE)]
    for probe in probes:
        print(f"  {work}: {json.dumps(probe)}")
    prealloc = all(p["ok"] for p in probes)
    if not prealloc:
        err_text = probes[-1]["error"] or probes[0]["error"]
        failing_run("-d -w --preallocfile where posix_fallocate fails",
                    ["-d", "-w", *common, *layout, "--preallocfile", bench],
                    json_path, err_text.split(": ", 1)[-1])
        print(f"  --preallocfile failed with the probe's error, as the JAX "
              f"package's does; the runs below go without it")
    write_flags = ["--trunc", "--statinline", "--sync", "--verify", "7",
                   *(["--preallocfile"] if prealloc else [])]
    try:
        print(f"lifecycle pass (a): dir mode, {' '.join(write_flags)}")
        for first, (mode, flags) in enumerate((("staged", []),
                                               ("--gpudirect",
                                                ["--gpudirect"]))):
            name = f"-w {' '.join(write_flags)} {mode}"
            phases = ["SYNC", "MKDIRS", "SYNC", "WRITE", "SYNC"] \
                if first == 0 else ["SYNC", "WRITE", "SYNC"]
            with lifecycle_calls(bench) as calls:
                recs, got = run_pass(
                    name, [*(["-d"] if first == 0 else []), "-w", *common,
                           *layout, *write_flags, *flags, bench], json_path,
                    phases)
            total += got
            write = recs[phases.index("WRITE")]
            expect(name, write, EntriesLast=files, ops=blocks,
                   device_ops=blocks, BytesLast=blocks * MAIN_BLOCK)
            for rec in recs:
                if rec["Phase"] == "SYNC":
                    expect(name, rec, EntriesLast=1, NumWorkers=1,
                           BytesLast=0, TpuHbmBytes=0)
            want_falloc = [(0, LIFECYCLE_FILE_SIZE)] * files if prealloc \
                else []
            if (calls["fstat"], calls["fallocate"], calls["o_trunc"]) != \
                    (files, want_falloc, files):
                fail(f"pass '{name}': {calls['fstat']} fstat calls, "
                     f"{len(calls['fallocate'])} posix_fallocate calls, "
                     f"{calls['o_trunc']} O_TRUNC opens; want {files}, "
                     f"{len(want_falloc)} and {files}")
            sizes = {os.path.getsize(os.path.join(d, f))
                     for d, _, names in os.walk(bench) for f in names}
            if sizes != {LIFECYCLE_FILE_SIZE}:
                fail(f"pass '{name}': file sizes {sizes}")
            print(f"  {name}: device {write['TpuHbmMiBPerSec']} MiB/s, "
                  f"storage {write['MiBPerSecLast']} MiB/s, "
                  f"{loop_taken(write)}; SYNC ms {sync_ms(recs)}")
            name = f"-r --statinline --gpuverify {mode}"
            with lifecycle_calls(bench) as calls:
                (rec,), got = run_pass(
                    name, ["-r", *common, *layout, "--statinline",
                           "--verify", "7", "--gpuverify", *flags, bench],
                    json_path, ["READ"])
            total += got
            expect(name, rec, EntriesLast=files, ops=blocks,
                   device_ops=blocks)
            if got != blocks or calls["fstat"] != files:
                fail(f"pass '{name}': {got} launches and {calls['fstat']} "
                     f"fstat calls, want {blocks} and {files}")
            print(f"  {name}: device {rec['TpuHbmMiBPerSec']} MiB/s, "
                  f"{got} launches, {loop_taken(rec)}")

        print("lifecycle pass (b): file mode --trunctosize")
        path = os.path.join(work, "lifecycle.bin")
        run_pass("-w the long file", ["-w", *common, "-s",
                                      f"{LIFECYCLE_LONG >> 20}M", path],
                 json_path, ["WRITE"])
        name = f"-w -s {LIFECYCLE_SHORT >> 20}M --trunctosize"
        (rec,), _ = run_pass(name, ["-w", *common, "-s",
                                    f"{LIFECYCLE_SHORT >> 20}M",
                                    "--trunctosize", path], json_path,
                             ["WRITE"])
        size = os.path.getsize(path)
        if size != LIFECYCLE_SHORT:
            fail(f"pass '{name}': the file is {size} bytes, want "
                 f"{LIFECYCLE_SHORT}")
        print(f"  {name}: device {rec['TpuHbmMiBPerSec']} MiB/s; the "
              f"{LIFECYCLE_LONG >> 20} MiB file is now {size} bytes")

        print("lifecycle pass (c): RMFILES of missing files")
        for rel in ("r0/d0/r0-f3", "r1/d0/r1-f7"):
            os.unlink(os.path.join(bench, rel))
        failing_run("-F with two files missing", ["-F", *common, *layout,
                                                  bench], json_path,
                    "No such file or directory")
        print("  -F: failed on a missing file as it must")
        recs, _ = run_pass("-F -D --nodelerr", ["-F", "-D", *common, *layout,
                                                "--nodelerr", bench],
                           json_path, ["RMFILES", "RMDIRS"])
        expect("-F -D --nodelerr", recs[0], EntriesLast=files)
        if os.listdir(bench):
            fail(f"the lifecycle tree is not empty after RMDIRS: "
                 f"{os.listdir(bench)}")
        print(f"  -F -D --nodelerr: {recs[0]['EntriesLast']} entries, the "
              f"tree is gone")

        print("lifecycle pass (d): --log 1 and --log 0 on a --gpuprofile "
              "read")
        for level in ("1", "0"):
            trace_dir = tempfile.mkdtemp(prefix="trace-", dir=work)
            out = _Tee(sys.stdout)
            with contextlib.redirect_stdout(out):
                (rec,), _ = run_pass(
                    f"-r --gpuprofile --log {level}",
                    ["-r", *common, "-s", f"{LIFECYCLE_SHORT >> 20}M",
                     "--gpuprofile", trace_dir, "--log", level, path],
                    json_path, ["READ"])
            printed = "GPU profile trace: " in out.text.getvalue()
            if printed != (level == "1") \
                    or os.listdir(trace_dir) != ["001_readfiles"]:
                fail(f"--log {level}: trace line printed {printed}, trace "
                     f"dirs {os.listdir(trace_dir)}")
            print(f"  --log {level}: trace line printed {printed}, device "
                  f"{rec['TpuHbmMiBPerSec']} MiB/s")
            shutil.rmtree(trace_dir)

        print("lifecycle pass (e): --dropcaches in a child, open() spied")
        child_json = os.path.join(work, "dropcaches.json")
        proc = subprocess.run(
            [sys.executable, "-c", _DROP_CACHES_CHILD, "-r", *common, "-s",
             f"{LIFECYCLE_SHORT >> 20}M", "--sync", "--dropcaches",
             "--nolive", "--jsonfile", child_json, path],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr)
        if proc.returncode != 0:
            fail(f"the --dropcaches child exited {proc.returncode}")
        written = json.loads(proc.stdout.rsplit("DROP_CACHES_WRITES", 1)[1]
                             .splitlines()[0])
        with open(child_json) as f:
            recs = [json.loads(line) for line in f]
        phases = [r["Phase"] for r in recs]
        want = ["SYNC", "DROPCACHE", "READ", "SYNC", "DROPCACHE"]
        drops = [r["EntriesLast"] for r in recs if r["Phase"] == "DROPCACHE"]
        if phases != want or drops != [1, 1] or written != ["3", "3"] \
                or any("cuda" not in r["Device"] for r in recs):
            fail(f"the --dropcaches child recorded {phases}, DROPCACHE "
                 f"entries {drops}, wrote {written}")
        print(f"  phases {phases}, the spy got {written}; READ device "
              f"{recs[2]['TpuHbmMiBPerSec']} MiB/s; SYNC ms {sync_ms(recs)}")
    finally:
        shutil.rmtree(bench, ignore_errors=True)
        with contextlib.suppress(FileNotFoundError):
            os.unlink(os.path.join(work, "lifecycle.bin"))
    secs = time.monotonic() - t_start
    print(f"lifecycle pass: {secs:.1f} s, {total} fingerprint launches")
    if total != 2 * blocks:
        fail(f"the lifecycle pass launched the kernel {total} times, want "
             f"{2 * blocks}")
    if secs > LIFECYCLE_LIMIT_S:
        fail(f"the lifecycle pass took {secs:.1f} s, over its "
             f"{LIFECYCLE_LIMIT_S} s")
    return total


PLACEMENT_LIMIT_S = 90          # the most the placement pass may take
PLACEMENT_SIZE = 2 << 30        # -s 2g of its --cores and --zones reads
PLACEMENT_SHARD_MIB = (1, 16)   # dryrun pass 2's shards: 1 MiB, the -b 16M
PLACEMENT_CAPTURE = (1 << 30, MAIN_BLOCK)  # the capture's -s 1G -b 16M
PLACEMENT_SLOTS = (1, 4)        # dryrun_multigpu(n) over these many slots


def placement_probe() -> dict:
    """What this machine offers --zones, tried on a thread of its own:
    NUMA sysfs, node 0's CPUs, whether the thread can be bound to them,
    and whether MPOL_BIND on node 0 reads back through get_mempolicy for
    the thread (set_mempolicy) and for an mmap'd buffer (mbind)."""
    import ctypes
    import mmap
    from elbencho_tpu_torch.utils import numa
    bound = (numa.MPOL_BIND, 1)
    probe = {"sysfs": numa.numa_is_available(),
             "node0_cpus": sorted(numa._node_cpus(0))}

    def tries():
        try:
            os.sched_setaffinity(0, set(probe["node0_cpus"]))
            probe["affinity"] = True
        except (OSError, ValueError):
            probe["affinity"] = False
        probe["thread_bind"] = numa.set_thread_mempolicy_bind(0) \
            and numa.get_thread_mempolicy() == bound
        numa.reset_thread_mempolicy()
        m = mmap.mmap(-1, 1 << 20)
        addr = ctypes.addressof(ctypes.c_char.from_buffer(m))
        probe["buffer_bind"] = numa.mbind_buffer(addr, 1 << 20, 0) \
            and numa.get_buffer_policy(addr) == bound
        m.close()

    thread = threading.Thread(target=tries)
    thread.start()
    thread.join()
    return probe


@contextlib.contextmanager
def prepared_workers():
    """A spy on LocalWorker.prepare: on each worker's thread, after its
    preparation, its affinity, thread memory policy and zone, the policy
    of each I/O slot, and whether the slots are page-locked; yields
    {rank: record}."""
    import torch
    from elbencho_tpu_torch.utils import numa
    from elbencho_tpu_torch.workers.local_worker import LocalWorker
    seen: "dict[int, dict]" = {}
    real = LocalWorker.prepare

    def spy(self):
        real(self)
        pool = self._staging_pool
        seen[self.rank] = {
            "affinity": sorted(os.sched_getaffinity(0)),
            "thread": numa.get_thread_mempolicy(),
            "zone": self._numa_zone,
            "slots": [numa.get_buffer_policy(a) for a in pool.slot_addrs],
            "pinned": all(torch.frombuffer(v, dtype=torch.uint8).is_pinned()
                          for v in pool.views)}

    LocalWorker.prepare = spy
    try:
        yield seen
    finally:
        LocalWorker.prepare = real


def zone_pool_check(bound) -> None:
    """Where mbind reads back, a staging pool of the main path's slots
    bound to zone 0 and page-locked (its slots and a registered aux slab,
    as a --zones --gpudirect worker's would be): every slot and aux
    buffer must report MPOL_BIND on node 0 and be pinned."""
    import ctypes
    import torch
    from elbencho_tpu_torch.utils import numa
    from elbencho_tpu_torch.utils.staging_pool import StagingPool
    pool = StagingPool(4, MAIN_BLOCK, numa_zone=0)
    try:
        pool.register_slots()
        aux = pool.alloc_aux(2, MAIN_BLOCK, register=True)
        addrs = pool.slot_addrs + [
            ctypes.addressof(ctypes.c_char.from_buffer(mv)) for mv in aux]
        policies = {numa.get_buffer_policy(a) for a in addrs}
        pinned = all(torch.frombuffer(v, dtype=torch.uint8).is_pinned()
                     for v in pool.views + aux)
        if policies != {bound} or not pinned:
            fail(f"a staging pool bound to zone 0: policies {policies}, "
                 f"pinned {pinned}")
        print(f"  StagingPool(4 x 16 MiB, numa_zone=0), registered, and a "
              f"registered aux slab: policies {policies}, pinned {pinned} "
              f"(mbind, then cudaHostRegister)")
    finally:
        pool.close()


def dryrun_launches(n: int, n_mesh: int) -> int:
    """The fingerprint launches of dryrun_multigpu(n) as placement_pass
    calls it: one per shard in each ingest step (pass 1, pass 2 twice per
    shard size), and one per mesh device and stripe plus one warm-up in
    each of the capture's two --gpuslice runs."""
    stripes = PLACEMENT_CAPTURE[0] // (n_mesh * PLACEMENT_CAPTURE[1])
    return n * (1 + 2 * len(PLACEMENT_SHARD_MIB)) \
        + 2 * n_mesh * (stripes + 1)


def placement_pass(work: str) -> int:
    """Placing the work on the devices and cores of the host; returns the
    fingerprint launches. Each run's device MiB/s beside its twin's (the
    same read without the flag) and the pass's wall time are printed,
    and the pass must end within PLACEMENT_LIMIT_S.

    (a) dryrun_multigpu(1) over the card and dryrun_multigpu(4) over four
        slots of it: the ingest step at tiny, 1 MiB and 16 MiB shards
        (pass 2 with a fresh process that must find the built kernel in
        _build/), the five collectives (the reductions over the distinct
        card), and the measured -w --gpuslice capture at -s 1G -b 16M
        (over the one card: n_devices 1), each with its launches counted
        exactly and its MULTIGPU_MEASURED line.
    (b) --cores with every core of this process's affinity on -r -t 4
        -b 16M --iodepth 4 --gpuids 0 --gpudirect of a 2 GiB file: each
        worker's thread must be bound to cores[rank % len].
    (c) --zones 0 on the same read, staged and --gpudirect. Where NUMA
        sysfs lists node 0 and set_mempolicy takes MPOL_BIND (probed
        first, printed), each worker's thread policy and every slot must
        be MPOL_BIND on node 0, and under --gpudirect the slots page-
        locked too; where sysfs lacks the node, each worker must log the
        JAX package's "not found" line, run unbound and exit 0; where the
        node is listed but the policy calls are refused, the threads are
        bound to its CPUs, the refusals logged, and the run exits 0. The
        pass prints which case held. Where mbind reads back, whatever
        sysfs lists, a staging pool bound to zone 0 and page-locked
        (zone_pool_check) must report MPOL_BIND and pinned slots."""
    import torch
    from elbencho_tpu_torch.entry import dryrun_multigpu
    from elbencho_tpu_torch.ops.verify import fingerprint_u32
    from elbencho_tpu_torch.utils import numa
    t_start = time.monotonic()
    total = 0
    cards = torch.cuda.device_count()
    print("placement pass (a): dryrun_multigpu")
    for n in PLACEMENT_SLOTS:
        n_mesh = min(n, cards)
        fingerprint_u32.launches.reset()
        t0 = time.monotonic()
        measured = dryrun_multigpu(
            n, shard_mib=PLACEMENT_SHARD_MIB,
            file_size=f"{PLACEMENT_CAPTURE[0] >> 20}M",
            block_size=f"{PLACEMENT_CAPTURE[1] >> 20}M", work_dir=work)
        launches = fingerprint_u32.launches.count
        secs = time.monotonic() - t0
        stripes = PLACEMENT_CAPTURE[0] // (n_mesh * PLACEMENT_CAPTURE[1])
        want = dryrun_launches(n, n_mesh)
        if launches != want or measured["n_devices"] != n_mesh \
                or measured["stripes"] != stripes \
                or measured["tier"] != "cuda_devices" \
                or sum(measured["per_chip_bytes"].values()) \
                != PLACEMENT_CAPTURE[0]:
            fail(f"dryrun_multigpu({n}): {launches} launches (want {want}), "
                 f"capture {measured}")
        total += launches
        print(f"  dryrun_multigpu({n}): {secs:.1f} s, {launches} launches; "
              f"capture {measured['value']} MiB/s over {n_mesh} device(s), "
              f"redistribution "
              f"{measured['ici_redist_usec'] / stripes:.1f} us/stripe, "
              f"best {measured['ici_gbps_hwm']} Gbit/s")

    path = os.path.join(work, "placement.bin")
    json_path = os.path.join(work, "placement.json")
    read = ["-r", "-t", "4", "-b", f"{MAIN_BLOCK >> 20}M", "--iodepth", "4",
            "--gpuids", "0", path]
    blocks = PLACEMENT_SIZE // MAIN_BLOCK
    rates: "dict[str, float]" = {}

    def read_run(name, flags):
        (rec,), launches = run_pass(name, [*read[:-1], *flags, path],
                                    json_path, ["READ"])
        expect(name, rec, BytesLast=PLACEMENT_SIZE,
               TpuHbmBytes=PLACEMENT_SIZE, ops=blocks, device_ops=blocks)
        if launches:
            fail(f"pass '{name}': {launches} fingerprint launches, want 0")
        rates[name] = rec["TpuHbmMiBPerSec"]
        return rec

    try:
        run_pass("-w the placement file",
                 ["-w", "-t", "2", "-b", f"{MAIN_BLOCK >> 20}M", "-s",
                  f"{PLACEMENT_SIZE >> 20}M", "--iodepth", "4", "--gpuids",
                  "0", path], json_path, ["WRITE"])
        cores = sorted(os.sched_getaffinity(0))
        print(f"placement pass (b): --cores {','.join(map(str, cores))}")
        read_run("-r --gpudirect", ["--gpudirect"])
        with prepared_workers() as seen:
            read_run("-r --gpudirect --cores",
                     ["--gpudirect", "--cores", ",".join(map(str, cores))])
        got = {rank: p["affinity"] for rank, p in sorted(seen.items())}
        if got != {r: [cores[r % len(cores)]] for r in range(4)}:
            fail(f"--cores: the workers' affinities are {got}")
        print(f"  --cores: worker affinities {got}; device "
              f"{rates['-r --gpudirect --cores']} MiB/s beside "
              f"{rates['-r --gpudirect']} without")

        probe = placement_probe()
        print(f"placement pass (c): --zones 0; probe {json.dumps(probe)}")
        zone_bound = bool(probe["node0_cpus"]) and probe["affinity"]
        case = ", ".join(
            ["node 0 listed" if probe["node0_cpus"] else "no NUMA node 0"]
            + (["threads bound to its CPUs"] if zone_bound else [])
            + ([f"{what} reads back MPOL_BIND"
                if probe[key] else f"{what} not applied"
                for key, what in (("thread_bind", "thread policy"),
                                  ("buffer_bind", "slab policy"))]
               if zone_bound else []))
        bound = (numa.MPOL_BIND, 1)
        if probe["buffer_bind"]:
            zone_pool_check(bound)
        for mode, flags in (("staged", []), ("--gpudirect", ["--gpudirect"])):
            twin = "-r --gpudirect" if flags else "-r staged"
            if twin not in rates:
                read_run(twin, flags)
            name = f"-r --zones 0 {mode}"
            err = _Tee(sys.stderr)
            with prepared_workers() as seen, contextlib.redirect_stderr(err):
                read_run(name, [*flags, "--zones", "0"])
            text = err.text.getvalue()
            missing = text.count("NUMA zone 0 not found or empty; skipping "
                                 "binding")
            if missing != (0 if probe["node0_cpus"] else 4):
                fail(f"{name}: {missing} 'not found' lines in case '{case}'")
            for rank, p in sorted(seen.items()):
                problems = []
                if flags and not p["pinned"]:
                    problems.append("slots not page-locked")
                if p["zone"] != (0 if zone_bound else None):
                    problems.append(f"zone {p['zone']}")
                if zone_bound and not set(p["affinity"]) \
                        <= set(probe["node0_cpus"]):
                    problems.append(f"affinity {p['affinity']}")
                if zone_bound and probe["thread_bind"] \
                        and p["thread"] != bound:
                    problems.append(f"thread policy {p['thread']}")
                if zone_bound and probe["buffer_bind"] \
                        and set(p["slots"]) != {bound}:
                    problems.append(f"slot policies {set(p['slots'])}")
                if problems:
                    fail(f"{name}: worker {rank} in case '{case}': "
                         f"{'; '.join(problems)}")
            logged = sorted({ln.split(" ERROR: ", 1)[1].split(":")[0]
                             for ln in text.splitlines()
                             if " ERROR: " in ln})
            print(f"  {name}: case '{case}'; worker 0 zone {seen[0]['zone']}, "
                  f"thread policy {seen[0]['thread']}, slot policies "
                  f"{sorted(set(seen[0]['slots']), key=str)}, pinned "
                  f"{seen[0]['pinned']}; logged {logged}; device "
                  f"{rates[name]} MiB/s beside {rates[twin]} without")
    finally:
        with contextlib.suppress(FileNotFoundError):
            os.unlink(path)
    secs = time.monotonic() - t_start
    print(f"placement pass: {secs:.1f} s, {total} fingerprint launches")
    if secs > PLACEMENT_LIMIT_S:
        fail(f"the placement pass took {secs:.1f} s, over its "
             f"{PLACEMENT_LIMIT_S} s")
    return total


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
        aio_race_control()
        check_ring_setup(engine, work)
        check_block_loop_race(engine, work)
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
        launches += runcontrol_pass(work)
        launches += output_pass(work)
        launches += live_pass(work)
        launches += fault_pass(work)
        launches += rwmix_pass(work)
        launches += blockmod_pass(work)
        corruption_run(work)
        os.unlink(os.path.join(work, "smoke.bin"))
        launches += striped_pass(work)
        launches += dataset_pass(work)
        losf_launches, losf_rates = losf_pass(work)
        launches += losf_launches
        launches += tree_pass(work, losf_rates)
        launches += mmap_pass(work)
        launches += access_pass(work)
        launches += lifecycle_pass(work)
        launches += placement_pass(work)
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
