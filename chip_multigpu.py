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
2. ``make_ingest_step`` over the same mesh: the scrambled shards and the
   global (sum, xor) against numpy's;
3. chip_smoke.py's ``CollectiveBench`` check over every device, each
   collective pattern: one step on random input against
   ``collective_plain`` (per device for ``ici``);
4. the CLI: ``--gpuslice`` without --gpuids, so that its mesh is every
   device, on a 1 GiB file at -t 4 -b 16M, --redistspec alltoall and
   replicate (records, stripes and launches checked), and each
   collective ``--gpubench`` pattern at -s 1G -b 16M with --gpuids
   naming every device (--gpubench alone means --gpuids 0, as in the
   JAX package): bytes and ops.

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

REPO = os.path.dirname(os.path.abspath(__file__))
SHARD = 16 << 20               # bytes per device and stripe (-b 16M)
SLICE_FILE = 1 << 30           # the CLI slice pass's file (-s 1G)
COLLECTIVE_SIZE = 1 << 30      # -s 1G of the collective patterns
PATTERNS = ("ici", "allgather", "reducescatter", "alltoall", "psum")


def ingest_step_check(mesh, smoke) -> None:
    import numpy as np
    from elbencho_tpu_torch.ops.verify import fingerprint_u32
    from elbencho_tpu_torch.parallel.ingest import (host_shard_to_devices,
                                                    make_ingest_step,
                                                    shard_slices)
    hosts, chips = mesh.shape
    rows, cols = 64 * hosts, 4096 * chips
    rng = np.random.default_rng(5)
    batch, bits = (rng.integers(0, 1 << 32, size=(rows, cols),
                                dtype=np.uint64).astype(np.uint32)
                   for _ in range(2))
    shards = host_shard_to_devices(mesh, batch)
    bit_shards = host_shard_to_devices(mesh, bits)
    before = fingerprint_u32.launches.count
    out, total, xor = make_ingest_step(mesh)(shards, bit_shards)
    launches = fingerprint_u32.launches.count - before
    want = batch ^ bits
    for o, (rs, cs), dev in zip(out, shard_slices(mesh, rows, cols),
                                mesh.devices.flat):
        if o.device != dev or not np.array_equal(
                o.cpu().numpy().view(np.uint32), want[rs, cs]):
            smoke.fail(f"ingest step: the shard on {dev} != numpy's xor")
    want_fp = (int(want.sum(dtype=np.uint64)) & smoke.MASK,
               int(np.bitwise_xor.reduce(want.reshape(-1))))
    if (total, xor) != want_fp or launches != mesh.devices.size:
        smoke.fail(f"ingest step: ({total:#x}, {xor:#x}) vs numpy "
                   f"{want_fp}, {launches} launches")
    print(f"  make_ingest_step {hosts}x{chips}: every shard and the global "
          f"(sum, xor) equal numpy's, {launches} launches")


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
        ingest_step_check(mesh, smoke)
        for pattern in PATTERNS:
            route = smoke.check_collective_step(pattern, devices, gen)
            print(f"  CollectiveBench {pattern} over {n} devices, route "
                  f"{route}: one step equals the plain version")
        cli_checks(work, n, smoke)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for line in smi.stdout.strip().splitlines():
        print(line.strip())
    print(f'{{"ok": true, "devices": {n}}}', flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
