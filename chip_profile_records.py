"""Does torch.profiler keep every host->device copy record when one process
writes several --gpuprofile traces?

Each variant runs in a child process of its own, which writes a 4 GiB file
once and then makes ten traced `-r --gpudirect -t 2 -b 16M` reads of it
(256 copies each), two untraced reads before each (new worker threads
every run, as in chip_smoke.py's process). A trace lost records when it
holds fewer HtoD copy records of the block's size than the copies the
read's counters report. Each worker thread makes one 4-byte copy at the
start of a traced phase (``CudaWorkerContext.profile_warmup``). Variants:

- ``plain``: nothing else in the process;
- ``after-kernel-phase``: chip_smoke.py's kernel phase first (the kernel
  checked and timed, a CUDA-only trace, two streams), the state of the
  smoke's own process when its traced reads lost records;
- ``after-kernel-phase-no-warmup``: the same without the warm-up copy;
- ``after-kernel-phase-no-warmup-acc``: the same, with every --gpuprofile
  trace made with ``acc_events=True``.

Needs one CUDA device and 5 GiB free in the repo's ``_smoke_data/``;
prints one line per traced read and one summary line per variant:

    python3 chip_profile_records.py
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "_smoke_data", "profile_records")
# the CLI runs write only their traces, inside the checkout: no default
# result files under /var/tmp
os.environ["ELBENCHO_TPU_NO_DEFAULT_RESFILES"] = "1"
VARIANTS = ("plain", "after-kernel-phase", "after-kernel-phase-no-warmup",
            "after-kernel-phase-no-warmup-acc")
TRACED_READS = 10
COMMON = ["-t", "2", "-b", "16M", "--iodepth", "4", "--gpuids", "0",
          "--nolive"]


def copy_records(trace_dir: str, block: int) -> "tuple[int, int]":
    """(HtoD copy records of ``block`` bytes, smaller HtoD records) of a
    run's one traced phase."""
    (sub,) = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, sub, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    sizes = [e["args"].get("bytes", 0) for e in events
             if e.get("ph") == "X" and e.get("cat") == "gpu_memcpy"
             and "HtoD" in e["name"]]
    return sum(s == block for s in sizes), sum(s < block for s in sizes)


def child(variant: str) -> None:
    import contextlib
    import torch
    import torch.profiler as tp

    sys.path.insert(0, REPO)
    from elbencho_tpu_torch.cli import main
    from elbencho_tpu_torch.cuda.device import CudaWorkerContext

    devnull = open(os.devnull, "w")  # the CLI's tables and log lines
    if variant.startswith("after-kernel-phase"):
        import chip_smoke
        with contextlib.redirect_stdout(devnull):
            chip_smoke.kernel_phase(torch.device("cuda", 0))
    if "-no-warmup" in variant:
        CudaWorkerContext.profile_warmup = lambda self: None
    if variant.endswith("-acc"):
        profile = tp.profile
        tp.profile = lambda **kw: profile(acc_events=True, **kw)

    def cli(args):
        with contextlib.redirect_stdout(devnull):
            assert main(args) == 0

    path = os.path.join(WORK, "f.bin")
    if not os.path.exists(path):
        cli(["-w", "-s", "4g", *COMMON, path])
    lost_runs = 0
    for i in range(TRACED_READS):
        for flags in (["-r"], ["-r", "--gpudirect"]):
            cli([*flags, *COMMON, path])
        trace_dir = os.path.join(WORK, f"{variant}_{i}")
        json_path = os.path.join(WORK, f"{variant}_{i}.json")
        cli(["-r", "--gpudirect", "--gpustream", "on", *COMMON,
             "--jsonfile", json_path, "--gpuprofile", trace_dir, path])
        with open(json_path) as f:
            rec = json.loads(f.readline())
        records, small = copy_records(trace_dir, 16 << 20)
        copies = rec["TpuH2dDirectOps"]
        lost_runs += records != copies
        print(f"{variant}: traced read {i + 1} (after {3 * i + 2} untraced "
              f"CLI runs): {records} HtoD records of 16 MiB for {copies} "
              f"copies, lost {copies - records}; {small} smaller HtoD "
              f"records", flush=True)
    print(f"SUMMARY {variant}: {lost_runs} of {TRACED_READS} traced reads "
          f"lost records", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_profile_records.py needs a CUDA device", file=sys.stderr)
        return 1
    os.makedirs(WORK, exist_ok=True)
    rc = 0
    try:
        for variant in VARIANTS:
            t0 = time.monotonic()
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), variant],
                cwd=REPO, capture_output=True, text=True, timeout=600)
            sys.stdout.write(proc.stdout)
            if proc.returncode:
                rc = 1
                sys.stdout.write(proc.stderr[-3000:])
            print(f"{variant}: {time.monotonic() - t0:.1f} s, exit "
                  f"{proc.returncode}", flush=True)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    return rc


if __name__ == "__main__":
    if len(sys.argv) > 1:
        child(sys.argv[1])
        sys.exit(0)
    sys.exit(main())
