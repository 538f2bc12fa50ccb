"""The port's multi-device paths across distinct CUDA devices of one host.

chip_smoke.py runs on one card, where the CLI's mesh has one device and
``SliceRunner`` reaches n > 1 only over repeated slots of cuda:0. This
script runs the same paths over every CUDA device of the machine, one
mesh slot per card (it needs two or more):

1. chip_smoke.py's ``SliceRunner`` check over ``make_ingest_mesh()``
   (every device), 16 MiB shards, every --redistspec: each device's
   buffer equals the plain version (torch indexing of the stripe), the
   folded fingerprint the host's with one kernel launch per device part,
   and a stripe with one flipped word is refused;
2. chip_smoke.py's ``CollectiveBench`` check over every device, each
   collective pattern: one step on random input against
   ``collective_plain`` (per device for ``ici``);
3. the CLI: ``--gpuslice`` without --gpuids, so that its mesh is every
   device, on a 1 GiB file at -t 4 -b 16M, --redistspec alltoall and
   replicate (records, stripes and launches checked), and each
   collective ``--gpubench`` pattern at -s 1G -b 16M with --gpuids
   naming every device (--gpubench alone means --gpuids 0, as in the
   JAX package): bytes and ops;
4. the staging slots' registration flags: a mapping registered with
   GPU 0 current, under flags 0 (the staging pool's) and
   cudaHostRegisterPortable, as every card sees it (is_pinned, a
   non_blocking copy's call and done times);
5. ``--gpufallback chip``: GPU 0 lost (simulated) mid-read of a
   -r -t n --gpudirect --gpuverify run over every card, 1 GiB a worker:
   exit 0, TpuChipFailovers 1, the worker's copies go on on the survivor
   its log line names, from slots page-locked there, every block
   verified on a card;
6. ``dryrun_multigpu(n)`` over the n distinct cards, sized as
   chip_smoke.py's placement pass sizes it on one: the ingest step at
   tiny, 1 MiB and 16 MiB shards with pass 2's build-cache check in a
   fresh process, the five collectives all at n (NCCL for the
   reductions), and the measured --gpuslice capture at -s 1G -b 16M over
   every card (its MULTIGPU_MEASURED line), launches counted exactly.

It prints each check and time on a line of its own, the cards' names and
power limits, and last one JSON line ``{"ok": true, "devices": n}``; any
failed check exits nonzero. The data lives in the repo's _smoke_data/
and is removed at the end:

    python3 chip_multigpu.py
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SHARD = 16 << 20               # bytes per device and stripe (-b 16M)
SLICE_FILE = 1 << 30           # the CLI slice pass's file (-s 1G)
COLLECTIVE_SIZE = 1 << 30      # -s 1G of the collective patterns
FAILOVER_PER_WORKER = 1 << 30  # the failover read's bytes a worker
PROBE_BYTES = 256 << 20        # the registration-flag probe's mapping
CUDA_HOST_REGISTER_PORTABLE = 1  # cuda_runtime_api.h
PATTERNS = ("ici", "allgather", "reducescatter", "alltoall", "psum")


def cli_checks(work: str, n: int, smoke) -> None:
    from elbencho_tpu_torch.stats.latency_histogram import LatencyHistogram
    path = os.path.join(work, "slice.bin")
    rc, _ = smoke.run_cli(["-w", "-t", "4", "-s", f"{SLICE_FILE >> 20}M",
                           "-b", "16M", path],
                          os.path.join(work, "write.json"))
    if rc != 0:
        smoke.fail("writing the slice pass's file failed")
    stripes = SLICE_FILE // (n * SHARD)
    for spec in ("alltoall", "replicate"):
        name = f"--gpuslice --redistspec {spec} over {n} devices"
        recs, launches = smoke.run_pass(name, [
            "--gpuslice", "-t", "4", "-s", f"{SLICE_FILE >> 20}M", "-b",
            "16M", "--redistspec", spec, path],
            os.path.join(work, "slice.json"), ["TPUSLICE"])
        rec = recs[0]
        smoke.expect(name, rec, TpuHbmBytes=SLICE_FILE,
                     ShardIngestMiB=SLICE_FILE >> 20,
                     IciRedistMiB=SLICE_FILE >> 20, EntriesLast=stripes,
                     BytesLast=SLICE_FILE)
        if launches != n * (stripes + 1):
            smoke.fail(f"pass '{name}': {launches} fingerprint launches, "
                       f"want {n * (stripes + 1)} (one per device part of "
                       f"{stripes} stripes and of the warm-up)")
        print(f"  {name}: {rec['MiBPerSecLast']} MiB/s, redistribution "
              f"{rec['IciRedistUSec'] / stripes:.1f} us/stripe, best "
              f"{rec['IciGbpsHwm']} Gbit/s, per chip {rec.get('TpuPerChip')}")
    for pattern in PATTERNS:
        name = f"--gpubench {pattern} over {n} devices"
        rec = smoke.bench_run(name, [
            "--gpubench", "--gpubenchpat", pattern, "--gpuids",
            ",".join(map(str, range(n))), "-s",
            f"{COLLECTIVE_SIZE >> 20}M", "-b", "16M"],
            os.path.join(work, "collective.json"))
        step = n * SHARD
        steps = -(-COLLECTIVE_SIZE // step)
        smoke.expect(name, rec, BytesLast=steps * step,
                     TpuHbmBytes=steps * step, ops=steps)
        histo = LatencyHistogram.from_dict(rec["IOLatHisto"])
        print(f"  {name}: {rec['TpuHbmMiBPerSec']} MiB/s, op latency p50 "
              f"{histo.percentile(50):.1f} us, p99 "
              f"{histo.percentile(99):.1f} us ({steps} steps of {n} x 16 "
              f"MiB)")


def register_flags_probe(n: int, smoke) -> None:
    """How a registration made with GPU 0 current serves the other cards,
    under flags 0 and cudaHostRegisterPortable: a PROBE_BYTES mapping is
    registered once, then on every card torch's is_pinned, the host-side
    time of one non_blocking host->device copy call (a copy from memory
    that is not page-locked for that card runs synchronously) and the
    copy's time to done. Prints one line per flag and card. (A second
    registration, with GPU 1 current, is refused under flag 0 too, and
    leaves its error for torch's next CUDA call to raise.)"""
    import ctypes
    import mmap

    import torch
    cudart = torch.cuda.cudart()
    for flags in (0, CUDA_HOST_REGISTER_PORTABLE):
        mapping = mmap.mmap(-1, PROBE_BYTES)
        base = ctypes.addressof(ctypes.c_char.from_buffer(mapping))
        src = torch.frombuffer(mapping, dtype=torch.uint8)
        src.fill_(7)
        with torch.cuda.device(0):
            err = int(cudart.cudaHostRegister(base, PROBE_BYTES, flags))
        if err:
            smoke.fail(f"cudaHostRegister(flags {flags}) failed: {err}")
        try:
            for dev in range(n):
                with torch.cuda.device(dev):
                    pinned = src.is_pinned()
                    dst = torch.empty(PROBE_BYTES, dtype=torch.uint8,
                                      device=f"cuda:{dev}")
                    dst.copy_(src, non_blocking=True)  # warm-up
                    torch.cuda.synchronize(dev)
                    t0 = time.perf_counter()
                    dst.copy_(src, non_blocking=True)
                    t_call = time.perf_counter()
                    torch.cuda.synchronize(dev)
                    t_done = time.perf_counter()
                    if not torch.equal(dst[-16:].cpu(), src[-16:]):
                        smoke.fail(f"flags {flags}: the copy to cuda:{dev} "
                                   f"lost bytes")
                    del dst
                print(f"  registered with flags {flags} on GPU 0; "
                      f"cuda:{dev}: "
                      f"is_pinned {pinned}, non_blocking call "
                      f"{(t_call - t0) * 1e3:.3f} ms, done after "
                      f"{(t_done - t0) * 1e3:.3f} ms "
                      f"({PROBE_BYTES / (t_done - t0) / 1e9:.2f} GB/s)")
        finally:
            with torch.cuda.device(0):
                cudart.cudaHostUnregister(base)
            del src
            mapping.close()


def failover_check(work: str, n: int, smoke) -> None:
    """--gpufallback chip over the cards: GPU 0 is lost (simulated) at its
    FAULT_LOSS_AT-th copy of a -r -t n --gpuids 0,..,n-1 --gpudirect
    --gpuverify read, 1 GiB a worker. Exit 0 with TpuChipFailovers 1; the
    failed-over worker's log line names its survivor, and every copy it
    makes after the loss goes to that card from slots page-locked there
    (is_pinned with the survivor current); every block is verified on a
    card (one launch each, none on the host)."""
    import contextlib

    import torch
    from elbencho_tpu_torch.cuda.device import CudaWorkerContext
    path = os.path.join(work, "failover.bin")
    size = n * FAILOVER_PER_WORKER
    blocks = size // SHARD
    ids = ",".join(map(str, range(n)))
    common = ["-t", str(n), "-b", "16M", "-s", f"{size >> 20}M",
              "--iodepth", "4", "--gpuids", ids, "--verify", "7"]
    rc, _ = smoke.run_cli(["-w", *common, path],
                          os.path.join(work, "write.json"))
    if rc != 0:
        smoke.fail("writing the failover pass's file failed")
    real = CudaWorkerContext.host_to_device
    state = {"calls": 0, "lost": None, "fired": None, "after": []}

    def failing(self, buf, length, **kwargs):
        if self.chip_id == 0 and state["lost"] is None:
            state["calls"] += 1  # only GPU 0's worker comes here
            if state["calls"] == smoke.FAULT_LOSS_AT:
                state["lost"] = self
                state["fired"] = time.monotonic()
                raise RuntimeError(smoke.CUDA_LOSS_TEXT)
        elif self is state["lost"]:
            with torch.cuda.device(self.device):
                pinned = torch.frombuffer(buf, dtype=torch.uint8,
                                          count=length).is_pinned()
            state["after"].append((time.monotonic(), str(self.device),
                                   pinned))
        return real(self, buf, length, **kwargs)

    name = (f"-r -t {n} --gpudirect --gpuverify, --gpufallback chip, GPU 0 "
            f"lost at copy {smoke.FAULT_LOSS_AT}")
    err = smoke._Tee()
    CudaWorkerContext.host_to_device = failing
    try:
        with contextlib.redirect_stderr(err):
            (rec,), launches = smoke.run_pass(
                name, ["-r", *common, "--gpudirect", "--gpuverify",
                       "--gpufallback", "chip", path],
                os.path.join(work, "failover.json"), ["READ"])
    finally:
        CudaWorkerContext.host_to_device = real
    smoke.expect(name, rec, BytesLast=size, TpuHbmBytes=size,
                 TpuChipFailovers=1, TpuH2dDirectOps=blocks)
    lines = [ln for ln in err.text.getvalue().splitlines()
             if "worker failed over to GPU" in ln]
    targets = {dev for _t, dev, _p in state["after"]}
    if len(lines) != 1 or len(targets) != 1:
        smoke.fail(f"pass '{name}': failover lines {lines}, copies after "
                   f"the loss on {sorted(targets)}")
    survivor = targets.pop()
    if not lines[0].endswith(f"GPU {survivor.split(':')[1]} "
                             f"(--gpufallback chip)"):
        smoke.fail(f"pass '{name}': the log names another survivor than "
                   f"{survivor}: {lines[0]}")
    pinned = sum(p for _t, _d, p in state["after"])
    if pinned != len(state["after"]):
        smoke.fail(f"pass '{name}': a slot is not page-locked on "
                   f"{survivor}")
    if launches != blocks:
        smoke.fail(f"pass '{name}': {launches} launches for {blocks} "
                   f"blocks (every block is verified on a card)")
    first = state["after"][0][0] - state["fired"]
    print(f"  {name}: exit 0, {rec['MiBPerSecLast']} MiB/s, "
          f"TpuChipFailovers 1; the worker of GPU 0 went on on {survivor} "
          f"({len(state['after'])} copies after the loss, first "
          f"{first * 1e6:.0f} us after it, {pinned} of them from slots "
          f"page-locked there); "
          f"{launches} launches for {blocks} blocks; per card "
          f"{rec.get('TpuPerChip')}")
    os.unlink(path)


def dryrun_check(work: str, n: int, smoke) -> None:
    from elbencho_tpu_torch.entry import dryrun_multigpu
    from elbencho_tpu_torch.ops.verify import fingerprint_u32
    size, block = smoke.PLACEMENT_CAPTURE
    fingerprint_u32.launches.reset()
    t0 = time.monotonic()
    measured = dryrun_multigpu(n, shard_mib=smoke.PLACEMENT_SHARD_MIB,
                               file_size=f"{size >> 20}M",
                               block_size=f"{block >> 20}M", work_dir=work)
    launches = fingerprint_u32.launches.count
    stripes = size // (n * block)
    want = smoke.dryrun_launches(n, n)
    if launches != want or measured["n_devices"] != n \
            or measured["stripes"] != stripes \
            or len(measured["per_chip_bytes"]) != n:
        smoke.fail(f"dryrun_multigpu({n}): {launches} launches (want "
                   f"{want}), capture {measured}")
    print(f"  dryrun_multigpu({n}) over {n} cards: "
          f"{time.monotonic() - t0:.1f} s, {launches} launches; capture "
          f"{measured['value']} MiB/s, redistribution "
          f"{measured['ici_redist_usec'] / stripes:.1f} us/stripe, best "
          f"{measured['ici_gbps_hwm']} Gbit/s")


def main() -> int:
    import torch
    sys.path.insert(0, REPO)
    import chip_smoke as smoke
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        smoke.fail("this check needs two or more CUDA devices")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    from elbencho_tpu_torch.parallel.mesh import make_ingest_mesh
    mesh = make_ingest_mesh()
    devices = list(mesh.devices.flat)
    n = len(devices)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {n} "
          f"devices, mesh {mesh.shape[0]}x{mesh.shape[1]}; NCCL "
          f"{torch.cuda.nccl.version()}")
    gen = torch.Generator(device=devices[0])
    gen.manual_seed(11)
    work = os.path.join(REPO, "_smoke_data", "multigpu")
    os.makedirs(work, exist_ok=True)
    try:
        smoke.check_slice_runner(devices, gen)
        for pattern in PATTERNS:
            route = smoke.check_collective_step(pattern, devices, gen)
            print(f"  CollectiveBench {pattern} over {n} devices, route "
                  f"{route}: one step equals the plain version")
        cli_checks(work, n, smoke)
        register_flags_probe(n, smoke)
        failover_check(work, n, smoke)
        dryrun_check(work, n, smoke)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for line in smi.stdout.strip().splitlines():
        print(line.strip())
    print(f'{{"ok": true, "devices": {n}}}', flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
