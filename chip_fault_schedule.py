"""How often does a fused-ring read with --ioretries 3 fail under the
engine's short-read fault schedule, counting every submit or first
submits only?

chip_smoke.py's fault pass reads its 4 GiB file through the ring with
every 5th storage op short. Under ``ELBENCHO_TPU_IO_FAULT=short:5`` (the
JAX package's schedule) the engine counts every submit, retries too, so
one op is faulted again whenever its retry lands on the schedule, which
the ring's completion order decides; four faults of one op spend its
three retries and fail the phase. Under ``short:5:0:first`` a retry is
neither faulted nor counted (``NativeStream.resubmit``).

The script writes a 4 GiB verify-pattern file once, then makes ROUNDS
rounds of one read under each schedule, alternating, at the fault pass's
width (``-r -t 2 -b 16M --iodepth 4 --gpuids 0 --gpudirect --gpustream
on --ioretries 3``), and prints one line per read and one summary line
per schedule: failed reads and the retries of each passed one.

Needs one CUDA device and 5 GiB free in the repo's ``_smoke_data/``:

    python3 chip_fault_schedule.py [ROUNDS]      # ROUNDS defaults to 20
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "_smoke_data", "fault_schedule")
SCHEDULES = ("short:5", "short:5:0:first")
COMMON = ["-t", "2", "-b", "16M", "--iodepth", "4", "--gpuids", "0"]
SIZE = 4 << 30


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: this needs a CUDA "
              "device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    os.makedirs(WORK, exist_ok=True)
    path = os.path.join(WORK, "f.bin")
    json_path = os.path.join(WORK, "res.json")
    results: "dict[str, list[dict]]" = {s: [] for s in SCHEDULES}
    try:
        rc, _ = cs.run_cli(["-w", *COMMON, "-s", f"{SIZE >> 20}M",
                            "--verify", "7", path], json_path)
        if rc:
            print(f"writing the file exited {rc}", file=sys.stderr)
            return 1
        os.environ["ELBENCHO_TPU_TESTING"] = "1"
        for i in range(rounds):
            for spec in SCHEDULES:
                os.environ["ELBENCHO_TPU_IO_FAULT"] = spec
                rc, recs = cs.run_cli(
                    ["-r", *COMMON, "--gpudirect", "--gpustream", "on",
                     "--ioretries", "3", path], json_path)
                os.environ.pop("ELBENCHO_TPU_IO_FAULT")
                row = {"round": i, "schedule": spec, "rc": rc}
                if rc == 0:
                    (rec,) = recs
                    row.update(bytes=rec["BytesLast"],
                               retries=rec["IoRetries"],
                               mib_s=rec["MiBPerSecLast"])
                results[spec].append(row)
                print(json.dumps(row), flush=True)
    finally:
        os.environ.pop("ELBENCHO_TPU_TESTING", None)
        shutil.rmtree(WORK, ignore_errors=True)
    for spec, rows in results.items():
        passed = [r for r in rows if r["rc"] == 0]
        print(json.dumps({
            "schedule": spec, "reads": len(rows),
            "failed": len(rows) - len(passed),
            "short_bytes": sum(r["bytes"] != SIZE for r in passed),
            "retries": sorted({r["retries"] for r in passed})}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
