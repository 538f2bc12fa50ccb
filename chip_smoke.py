#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (elbencho_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

It needs one CUDA device and the repository beside it, and exits nonzero
without printing a result otherwise. In order it:

1. prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions and the kernel build time;
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
   reduction) at 1 to 256 MiB, the main path's 16 MiB block among them;
3. drives the port's main path through its CLI on a 4 GiB file
   (-s 10g of the README's headline command, cut to fit the smoke's time):
   write+read with --verify and --gpuverify, a --gpudirect read, and a plain
   write+read through the device fill pool; asserts bytes, ops, that the
   kernel ran once per block read under --gpuverify, and that --gpudirect
   copied from page-locked slots;
4. flips one byte of the file and checks that the --gpuverify read fails,
   with the kernel's integrity error and after launching the kernel;
5. prints the kernel line {"kernels": [...]} and, last, the result line
   {"ok": true, "device": {...}}.

Any failed phase exits nonzero. The data file lives in _smoke_data/ of the
checkout (listed in .gitignore) and is removed at the end.
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
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
MAIN_BLOCK = 16 << 20          # bytes per block on the main path (-b 16M)
MAIN_SIZE = 4 << 30            # -s 4g
MAIN_BLOCKS = MAIN_SIZE // MAIN_BLOCK
HBM_BYTES_PER_SEC = 3.35e12    # H100 SXM device memory, NVIDIA data sheet
KERNEL_WORD_COUNTS = (1, 127, 128, 4097, 262144, 4 << 20, 64 << 20)
TIMING_MIB = (1, 4, 16, 64, 256)  # block sizes the kernel is timed at
TIMING_POOL = 512 << 20       # distinct bytes the timing rotates over (> L2)
INTEGRITY_ERROR = "on-device integrity check failed"


class _TeeStderr(io.TextIOBase):
    """stderr that is also kept in ``text``."""

    def __init__(self):
        self.text = io.StringIO()
        self._stream = sys.stderr

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
    `reps` calls, after a warm-up. Each round is queued behind a ~0.1 s
    device sleep, so the host has enqueued every call before the start
    event runs: the CUDA events then time the device work alone, and the
    host clock times the per-call launch cost."""
    import torch
    fn()
    torch.cuda.synchronize()
    rounds, host_rounds = [], []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)  # cycles, ~0.1 s at H100 clocks
        start.record()
        t_host = time.perf_counter()
        for i in range(reps):
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
    grid x threads x loads x 4 words), and a few words, at every 4-byte
    offset from a 16-byte boundary."""
    from elbencho_tpu_torch.ops.verify import TILE_VECS, launch_shape
    sms, per_sm = launch_shape(dev.index)
    edge = sms * per_sm * TILE_VECS * 4
    max_err = 0
    for n in (0, 2, 3, 5, 4 * TILE_VECS - 1, 4 * TILE_VECS + 1, edge - 1,
              edge + 1):
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
    and nothing else on the device (no zero fill)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from elbencho_tpu_torch.ops.verify import fingerprint_u32
    fingerprint_u32(words)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fingerprint_u32(words)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    ours = sum("fingerprint_u32_kernel" in n for n in names)
    others = sorted({n for n in names if "fingerprint_u32_kernel" not in n})
    if not names:
        fail("torch.profiler recorded no device activity for 10 calls, so "
             "one launch per call is not shown")
    print(f"  device activity of 10 calls (torch.profiler): {ours} "
          f"fingerprint kernels, other device work: {others or 'none'}")
    if ours != 10 or others:
        fail(f"10 calls enqueued {ours} fingerprint kernels and {others}")


def time_sizes(dev, gen) -> "dict[int, dict]":
    """Kernel, torch.sum (int64) and plain device ms per call at each
    size in TIMING_MIB, rotating over distinct blocks of one 512 MiB
    pool so that each launch reads device memory, not L2."""
    import torch
    from elbencho_tpu_torch.ops.verify import (fingerprint_u32,
                                               fingerprint_u32_plain)
    pool = rand_words(TIMING_POOL // 4, gen, dev)
    rows = {}
    print("fingerprint_u32 by block size (device ms per call, bound = "
          "bytes / 3.35 TB/s; torch.sum int64 is the sum half only: no "
          "PyTorch call computes the xor reduction):")
    for mib in TIMING_MIB:
        n = (mib << 20) // 4
        k = TIMING_POOL // (mib << 20)
        blocks = [pool[i * n:(i + 1) * n] for i in range(k)]
        ms, host_ms = cuda_ms(lambda i=0: fingerprint_u32(blocks[i % k]),
                              200)
        library_ms, _ = cuda_ms(
            lambda i=0: torch.sum(blocks[i % k], dtype=torch.int64), 100)
        plain_ms, _ = cuda_ms(
            lambda i=0: fingerprint_u32_plain(blocks[i % k]), 10)
        bound_ms = (mib << 20) / HBM_BYTES_PER_SEC * 1e3
        rows[mib] = {"ms": ms, "bound_ms": bound_ms, "plain_ms": plain_ms,
                     "library_ms": library_ms}
        print(f"  {mib:>4} MiB ({k:>3} distinct blocks): kernel {ms:.4f} "
              f"ms, bound {bound_ms:.4f} ms, {bound_ms / ms:.1%} of the "
              f"bound, {(mib << 20) / ms / 1e6:.1f} GB/s; torch.sum int64 "
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
    main = rows[MAIN_BLOCK >> 20]
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


def main_path(work: str) -> int:
    """Drive the port's CLI; returns the fingerprint launches of the run."""
    from elbencho_tpu_torch.ops.verify import fingerprint_u32
    path = os.path.join(work, "smoke.bin")
    common = ["-t", "2", "-b", "16M", "-s", f"{MAIN_SIZE >> 20}M",
              "--iodepth", "4", "--gpuids", "0", path]
    verify = ["--verify", "7", "--gpuverify"]
    passes = (
        ("write+read, --gpuverify", ["-w", "-r", *verify], MAIN_BLOCKS),
        ("read, --gpudirect --gpuverify", ["-r", "--gpudirect", *verify],
         MAIN_BLOCKS),
        ("write+read, device fill pool", ["-w", "-r"], 0),
    )
    launches_before = 0
    fingerprint_u32.launches.reset()
    for i, (name, flags, want_launches) in enumerate(passes):
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
                  f"{rec['TpuPipeFullStalls']}, on {rec['Device']}")
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
        if launches != want_launches:
            fail(f"pass '{name}': {launches} fingerprint launches, want "
                 f"{want_launches} (one per block read under --gpuverify)")
    return fingerprint_u32.launches.count


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
    launches_before = fingerprint_u32.launches.count
    # the read must fail for the integrity check's reason alone, not for a
    # launch, registration or setup error: keep its stderr and look
    err = _TeeStderr()
    with contextlib.redirect_stderr(err):
        rc, _ = run_cli(["-r", "-t", "2", "-b", "16M", "--iodepth", "4",
                         "--verify", "7", "--gpuids", "0", "--gpuverify",
                         path],
                        os.path.join(work, "corrupt.json"))
    launches = fingerprint_u32.launches.count - launches_before
    if rc == 0:
        fail("the --gpuverify read of a corrupted file succeeded")
    if INTEGRITY_ERROR not in err.text.getvalue():
        fail(f"the --gpuverify read of a corrupted file failed (rc {rc}), "
             f"but not with '{INTEGRITY_ERROR}'")
    if launches == 0:
        fail("the corruption run failed without launching the fingerprint "
             "kernel")
    print(f"corruption run: --gpuverify read of a file with one flipped "
          f"byte failed as it must (rc {rc}, '{INTEGRITY_ERROR}' after "
          f"{launches} fingerprint launches)")


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

    work = os.path.join(REPO, "_smoke_data")
    os.makedirs(work, exist_ok=True)
    free = shutil.disk_usage(work).free
    if free < MAIN_SIZE + (1 << 30):
        fail(f"{work} has {free >> 20} MiB free; the main path needs a "
             f"{MAIN_SIZE >> 20} MiB file plus 1 GiB of headroom")
    try:
        kernel["launches"] = main_path(work)
        corruption_run(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print(f"total {time.monotonic() - t_start:.1f} s")
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
