"""Entry points of the port, the counterparts of ``__graft_entry__``:

- ``entry()``: the flagship device step (xor scramble + the fingerprint
  kernel) and its arguments for one 1 MiB block;
- ``dryrun_multigpu(n)``: the sharded ingest step, the five collectives
  and a measured ``--gpuslice`` capture over n mesh slots, the check the
  JAX package ships as ``dryrun_multichip`` for a multi-chip host;
- ``capture_multigpu(n, ...)``: that capture alone, the counterpart of
  ``bench.capture_multichip``.

    from elbencho_tpu_torch.entry import entry, dryrun_multigpu
    step, args = entry()          # on the current CUDA device
    scrambled, total, xor = step(*args)
    dryrun_multigpu(4)            # 4 slots over the CUDA devices
    dryrun_multigpu(8, device="cpu")   # 8 CPU slots, no device needed

Each runs on the CUDA devices and raises without them, unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import datetime
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

_REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_MASK = 0xFFFFFFFF

#: bytes per collective step of the dry run's pass 3 (the JAX package's)
DRYRUN_COLLECTIVE_BYTES = 64 * 1024

#: the child process of pass 2's build-cache check: it loads the
#: fingerprint kernel and prints how cuda_build found it
_CACHE_CHILD = (
    "import json, sys; sys.path.insert(0, {repo!r}); "
    "from elbencho_tpu_torch.ops.cuda_build import build_reports, "
    "load_library; load_library('fingerprint'); "
    "print(json.dumps(build_reports['fingerprint']))")


def entry(device=None):
    """(ingest_block_step, (block, bits)) on a 1 MiB block; ``device``
    None means the current CUDA device, and raises without one."""
    from .models.workloads import example_block, ingest_block_step
    block, bits = example_block(1 << 20, device)
    return ingest_block_step, (block, bits)


class DryRunError(RuntimeError):
    """A check of ``dryrun_multigpu`` failed; the message names its pass."""


def mesh_slots(n: int, device=None) -> "list[torch.device]":
    """n mesh slots: with ``device`` None (or "cuda") the CUDA devices,
    distinct cards where there are at least n, else dealt round-robin
    over the cards there are; with ``device="cpu"`` n CPU slots, the
    counterpart of the JAX package's virtual CPU devices."""
    if n < 1:
        raise ValueError(f"the mesh needs at least one slot, got {n}")
    if device is not None and torch.device(device).type != "cuda":
        if torch.device(device).type != "cpu":
            raise ValueError(f"mesh slots lie on CUDA devices or on the "
                             f"CPU, not on {device}")
        return [torch.device("cpu")] * n
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the multi-device dry run needs CUDA devices, but "
            "torch.cuda.is_available() is false (pass device='cpu' to run "
            "on CPU slots)")
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def _slots_name(slots) -> str:
    distinct = list(dict.fromkeys(slots))
    if len(distinct) == len(slots):
        return f"{len(slots)} device(s)"
    return f"{len(slots)} slots over {len(distinct)} device(s)"


def _card_label() -> str:
    """"<name>, <power limit>" of the first card as nvidia-smi reports
    them, or torch's name of it where nvidia-smi cannot be run."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True).stdout
        return out.strip().splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(0)}, power limit not read"


def _ingest_pass(mesh, rows: int, cols: int, name: str) -> int:
    """One sharded ingest step on a (rows, cols) uint32 batch (the JAX
    dry run's ``np.arange`` batch) with bits from a numpy generator
    seeded 7: every scrambled shard must lie on its device and equal
    numpy's ``batch ^ bits`` slice, and the global (sum mod 2^32, xor)
    numpy's. Returns the fingerprint kernel's launches (one per shard on
    CUDA, none on the CPU)."""
    from .ops.verify import fingerprint_u32
    from .parallel.ingest import (host_shard_to_devices, make_ingest_step,
                                  shard_slices)
    batch = np.arange(rows * cols, dtype=np.uint32).reshape(rows, cols)
    bits = np.random.default_rng(7).integers(
        0, 1 << 32, size=(rows, cols), dtype=np.uint64).astype(np.uint32)
    step = make_ingest_step(mesh)
    shards = host_shard_to_devices(mesh, batch)
    bit_shards = host_shard_to_devices(mesh, bits)
    before = fingerprint_u32.launches.count
    out, total, xor = step(shards, bit_shards)
    launches = fingerprint_u32.launches.count - before
    want = batch ^ bits
    for d, (o, (rs, cs), dev) in enumerate(zip(
            out, shard_slices(mesh, rows, cols), mesh.devices.flat)):
        if o.device != dev or not np.array_equal(
                o.cpu().numpy().view(np.uint32), want[rs, cs]):
            raise DryRunError(f"dryrun_multigpu {name}: shard {d} on {dev} "
                              f"differs from numpy's batch ^ bits")
    want_fp = (int(want.sum(dtype=np.uint64)) & _MASK,
               int(np.bitwise_xor.reduce(want.reshape(-1))))
    if (total, xor) != want_fp:
        raise DryRunError(f"dryrun_multigpu {name}: global (sum, xor) "
                          f"({total:#x}, {xor:#x}) != numpy's "
                          f"({want_fp[0]:#x}, {want_fp[1]:#x})")
    on_cuda = mesh.devices.flat[0].type == "cuda"
    if launches != (mesh.devices.size if on_cuda else 0):
        raise DryRunError(f"dryrun_multigpu {name}: {launches} fingerprint "
                          f"launches for {mesh.devices.size} shards")
    return launches


def _build_cache_check() -> str:
    """Pass 2's counterpart of the JAX package's persistent-cache check:
    a fresh process loads the fingerprint kernel this process built or
    found, and must find it in ``_build/`` (report ``(0.0, "cached")``)
    without adding a file there. Returns the line to print."""
    from .ops.cuda_build import BUILD_DIR
    before = sorted(os.listdir(BUILD_DIR))
    proc = subprocess.run([sys.executable, "-c",
                           _CACHE_CHILD.format(repo=_REPO_DIR)],
                          capture_output=True, text=True, timeout=300,
                          cwd=_REPO_DIR)
    after = sorted(os.listdir(BUILD_DIR))
    lines = proc.stdout.strip().splitlines()
    report = json.loads(lines[-1]) if proc.returncode == 0 and lines \
        else None
    if report != [0.0, "cached"] or after != before:
        raise DryRunError(
            f"dryrun_multigpu pass 2: a fresh process did not reuse the "
            f"built kernel (report {report}, rc {proc.returncode}, _build/ "
            f"{len(before)} -> {len(after)} files)\n{proc.stderr[-2000:]}")
    return (f"a fresh process loaded the fingerprint kernel from _build/ "
            f"(report {tuple(report)}, {len(after)} files, none added)")


def _collective_pass(slots) -> "list[str]":
    """Pass 3: each collective pattern's CollectiveBench at 64 KiB,
    warmed up and stepped once, then one compute() on seeded input held
    against collective_plain (per device for ici). NCCL takes distinct
    devices only, so over slots that share a card the three reductions
    run over the distinct cards among the slots; ici and alltoall run
    over every slot. Returns one line per pattern: route and devices."""
    from .config.args import COLLECTIVE_PATTERNS
    from .workers.gpubench import CollectiveBench
    distinct = list(dict.fromkeys(slots))
    on_cuda = slots[0].type == "cuda"
    lines = []
    for k, pattern in enumerate(COLLECTIVE_PATTERNS):
        devs = distinct if on_cuda and pattern not in ("ici", "alltoall") \
            else slots
        bench = CollectiveBench(pattern, devs, DRYRUN_COLLECTIVE_BYTES)
        bench.warmup()
        lat = bench.step()
        if lat < 0 or bench.bytes_per_step < DRYRUN_COLLECTIVE_BYTES:
            raise DryRunError(f"dryrun_multigpu pass 3: {pattern} step "
                              f"{lat} us, {bench.bytes_per_step} bytes")
        rng = np.random.default_rng(100 + k)
        words = bench.arrays[0].numel()
        bench.arrays = [torch.from_numpy(rng.integers(
            -(1 << 31), 1 << 31, size=words, dtype=np.int64).astype(
                np.int32)).to(d) for d in devs]
        if not bench.equals_plain():
            raise DryRunError(f"dryrun_multigpu pass 3: {pattern} over "
                              f"{_slots_name(devs)} differs from its plain "
                              f"version")
        lines.append(f"{pattern} over {_slots_name(devs)}, route "
                     f"{bench.route}: step {lat} us, "
                     f"{bench.bytes_per_step} bytes, one step equals the "
                     f"plain version")
    return lines


def dryrun_multigpu(n_devices: int, device=None, *,
                    shard_mib: "tuple[int, ...]" = (1,),
                    file_size: str = "4M", block_size: str = "128K",
                    work_dir: "str | None" = None) -> dict:
    """The passes of the JAX package's ``dryrun_multichip`` over n mesh
    slots (``mesh_slots``): prints a line per pass and last
    ``MULTIGPU_MEASURED <json>``; raises DryRunError naming the pass
    whose check failed. Returns pass 5's capture.

    1. ``make_ingest_mesh`` and one ingest step at rows = hosts * 8,
       cols = chips * 128 (``_ingest_pass``).
    2. The same at square shards of each ``shard_mib`` MiB (1 MiB: 512 x
       512 words), each run twice; between the first two runs, on CUDA, a
       fresh process must find the built kernel in ``_build/`` (the JAX
       package's persistent-cache check). On the CPU nothing is built, and
       the pass says so.
    3. The five collectives at 64 KiB (``_collective_pass``).
    4. The JAX package's control plane (a master and two services) is not
       run here: the port has no service mode yet.
    5. ``capture_multigpu`` at ``file_size``/``block_size``: ``value``
       must be set and ``ici_redist_mib`` above 0."""
    from .parallel.mesh import make_ingest_mesh
    slots = mesh_slots(n_devices, device)
    mesh = make_ingest_mesh(slots)
    h, c = mesh.shape
    on_cuda = slots[0].type == "cuda"
    where = f"{h}x{c} mesh over {_slots_name(slots)}"

    launches = _ingest_pass(mesh, h * 8, c * 128, "pass 1")
    print(f"dryrun_multigpu pass 1: ingest step {h * 8}x{c * 128} on the "
          f"{where}: every shard and the global (sum, xor) equal numpy's; "
          f"{launches} launches", flush=True)
    for k, mib in enumerate(shard_mib):
        side = int(round(((mib << 20) // 4) ** 0.5))
        if side * side * 4 != mib << 20:
            raise ValueError(f"a {mib} MiB shard is not square in words")
        launches = _ingest_pass(mesh, h * side, c * side, "pass 2")
        if k == 0:
            cache = _build_cache_check() if on_cuda else \
                "no kernel is built on the CPU: the build-cache check " \
                "does not apply"
        launches += _ingest_pass(mesh, h * side, c * side, "pass 2")
        print(f"dryrun_multigpu pass 2: {mib} MiB shards "
              f"({h * side}x{c * side}) on the {where}, twice: equal to "
              f"numpy's; {launches} launches"
              + (f"; {cache}" if k == 0 else ""), flush=True)
    for line in _collective_pass(slots):
        print(f"dryrun_multigpu pass 3: {line}", flush=True)
    print("dryrun_multigpu pass 4: the control plane (master, services) "
          "is not run: the port has no service mode yet", flush=True)
    measured = capture_multigpu(n_devices, file_size, block_size,
                                device=device, work_dir=work_dir)
    if measured.get("value") is None:
        raise DryRunError(f"dryrun_multigpu pass 5: the slice capture "
                          f"failed: {measured.get('error')}")
    if not measured.get("ici_redist_mib", 0) > 0:
        raise DryRunError(f"dryrun_multigpu pass 5: nothing redistributed: "
                          f"{measured}")
    print("MULTIGPU_MEASURED " + json.dumps(measured), flush=True)
    return measured


def capture_multigpu(n_devices: int, file_size: str, block_size: str,
                     device=None, work_dir: "str | None" = None) -> dict:
    """The measured slice capture: the real ``-w --gpuslice -t 2`` phase
    through the port's CLI, run twice (the first run builds the kernel and
    sets NCCL and the streams up; the second is measured), in a temporary
    directory (under ``work_dir`` if given). Returns the JAX capture's
    keys, the tier label leading ``metric`` so that the number never
    reads as another tier's; on failure ``value`` is None and ``error``
    says why. ``per_chip_bytes`` has one row per mesh device, as in the
    JAX capture, and ``n_devices`` counts them.

    The mesh is the phase's own: on CUDA every card when there are at
    most n (no --gpuids), so n slots over fewer cards run over the
    distinct cards and ``n_devices`` records how many. Where there are
    more, --gpuids 0..n-1 at -t max(2, n): every worker then has a card,
    and the record keeps one row per worker's card, so worker i feeds
    mesh device i alone (device d goes to worker d % threads) and the rows
    are the mesh devices'. On the CPU, n slots by --meshshape (the
    balanced factorization of n, as the JAX capture's mesh)."""
    from .cli import main as cli_main
    from .parallel.mesh import make_ingest_mesh
    slots = mesh_slots(n_devices, device)
    threads = 2
    if slots[0].type == "cuda":
        count = torch.cuda.device_count()
        n_mesh = min(n_devices, count)
        mesh_args = []
        if n_devices < count:
            mesh_args = ["--gpuids", ",".join(map(str, range(n_devices)))]
            threads = max(2, n_devices)
        tier = "cuda_devices"
        metric = (f"MULTIGPU slice ({tier}: {n_mesh} x {_card_label()}): "
                  f"sharded ingest + redistribution")
        run_device = None
    else:
        n_mesh = n_devices
        hosts, chips = make_ingest_mesh(slots).shape
        mesh_args = ["--meshshape", f"{hosts}x{chips}"]
        tier = "cpu_slots"
        metric = ("MULTIGPU slice (cpu_slots, NOT a GPU): sharded ingest + "
                  "redistribution")
        run_device = "cpu"
    failed = {"metric": metric, "tier": tier, "n_devices": n_mesh,
              "value": None}
    tmpdir = tempfile.mkdtemp(prefix="elbencho_tpu_torch_multigpu_",
                              dir=work_dir)
    jf = os.path.join(tmpdir, "slice.json")
    # all three result files named: no default ones outside tmpdir
    argv = ["--nolive", "-w", "--gpuslice", "-t", str(threads), "-s",
            file_size,
            "-b", block_size, *mesh_args, "--jsonfile", jf,
            "--resfile", os.path.join(tmpdir, "slice.txt"),
            "--csvfile", os.path.join(tmpdir, "slice.csv"),
            os.path.join(tmpdir, "slicefile")]
    try:
        for _run in range(2):
            if os.path.exists(jf):
                os.unlink(jf)  # the measured run's records alone
            rc = cli_main(argv, device=run_device)
            if rc != 0:
                return {**failed, "error": f"the --gpuslice run exited "
                                           f"{rc} (its errors are above)"}
        with open(jf) as f:
            recs = [json.loads(line) for line in f if line.strip()]
        rec = next(r for r in recs if r["Phase"] == "TPUSLICE")
        redist_usec = rec.get("IciRedistUSec", 0)
        redist_mib = rec.get("IciRedistMiB", 0)
        return {
            "metric": metric,
            "tier": tier,
            "n_devices": n_mesh,
            # shard-ingest rate: storage -> each device's memory across
            # the mesh, over the phase's wall time
            "value": rec.get("TpuHbmMiBPerSec", 0),
            "unit": "MiB/s",
            "shard_ingest_mib": rec.get("ShardIngestMiB", 0),
            "ici_redist_mib": redist_mib,
            "ici_redist_usec": redist_usec,
            # the redistribution's rate over its busy window alone
            "ici_redist_mibs": round(redist_mib / (redist_usec / 1e6), 1)
            if redist_usec else 0,
            "ici_gbps_hwm": rec.get("IciGbpsHwm", 0),
            "redist_spec": "alltoall",
            "stripes": rec.get("EntriesLast", 0),
            "per_chip_bytes": {k: v.get("Bytes", 0) for k, v in
                               rec.get("TpuPerChip", {}).items()},
            "utc": datetime.datetime.now(datetime.timezone.utc).strftime(
                "%Y-%m-%dT%H:%M:%SZ"),
        }
    except (OSError, ValueError, StopIteration) as err:
        return {**failed, "error": str(err)[-800:]}
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
