"""Statistics: first-done/last-done phase results + the JSON record.

Reference: elbencho_tpu/stats/statistics.py (source/Statistics.{h,cpp}),
cut to the phase result table and the JSON record (``_result_record``,
``_write_json``) with the device keys and the path-audit counters. Live
statistics and CSV output are not ported.

JSON keys keep the JAX package's names, so records of both packages
compare key by key and tools/elbencho-tpu-summarize-json reads them;
"Tpu" in a key means "the device" (here a GPU, named in "Device").
"""

from __future__ import annotations

import json
import time

from ..cuda.device import sum_path_audit_counters
from ..phases import BenchPhase, phase_entry_type, phase_name
from .latency_histogram import LatencyHistogram


def _fmt_elapsed_usec(usec: int) -> str:
    secs = usec / 1_000_000
    if secs >= 60:
        m, s = divmod(secs, 60)
        return f"{int(m)}m{s:.1f}s"
    if secs >= 1:
        return f"{secs:.3f}s"
    return f"{usec / 1000:.2f}ms"


class PhaseResults:
    """Aggregated first-done/last-done numbers for one finished phase."""

    def __init__(self):
        self.phase: BenchPhase = BenchPhase.IDLE
        self.phase_name = ""
        self.entry_type = "files"
        self.first_done_usec = 0
        self.last_done_usec = 0
        self.stonewall = {"entries": 0, "bytes": 0, "iops": 0}
        self.final = {"entries": 0, "bytes": 0, "iops": 0}
        self.iops_histo = LatencyHistogram()
        self.entries_histo = LatencyHistogram()
        self.cpu_stonewall = 0.0
        self.cpu_last_done = 0.0
        self.elapsed_usec_vec: "list[int]" = []
        self.tpu_bytes = 0
        self.tpu_usec = 0           # copy wall time (submit -> done)
        self.tpu_dispatch_usec = 0  # host-side submit cost of the pipeline
        self.tpu_per_chip: "dict[int, tuple[int, int]]" = {}
        self.tpu_path_counters: "dict[str, int]" = {}
        self.devices: "list[str]" = []
        self.num_workers = 0


def device_label(device) -> str:
    """'cuda:0 (NVIDIA H100 80GB HBM3)' or 'cpu': every record names the
    device its device numbers come from."""
    if device.type == "cuda":
        import torch
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)


class Statistics:
    def __init__(self, cfg, worker_manager):
        self.cfg = cfg
        self.manager = worker_manager

    def generate_phase_results(self, phase: BenchPhase) -> PhaseResults:
        res = PhaseResults()
        res.phase = phase
        res.phase_name = phase_name(phase)
        res.entry_type = phase_entry_type(phase)
        res.cpu_stonewall = self.manager.shared.cpu_util_stonewall
        res.cpu_last_done = self.manager.shared.cpu_util_last_done
        workers = [w for w in self.manager.workers if w.got_phase_work]
        res.num_workers = len(workers)
        for w in workers:
            res.elapsed_usec_vec.extend(w.elapsed_usec_vec)
            res.stonewall["entries"] += w.stonewall_ops.num_entries_done
            res.stonewall["bytes"] += w.stonewall_ops.num_bytes_done
            res.stonewall["iops"] += w.stonewall_ops.num_iops_done
            res.final["entries"] += w.live_ops.num_entries_done
            res.final["bytes"] += w.live_ops.num_bytes_done
            res.final["iops"] += w.live_ops.num_iops_done
            res.iops_histo.merge(w.iops_latency_histo)
            res.entries_histo.merge(w.entries_latency_histo)
            res.tpu_bytes += w.gpu_transfer_bytes
            res.tpu_usec += w.gpu_transfer_usec
            res.tpu_dispatch_usec += w.gpu_dispatch_usec
            if w._gpu is not None:
                chip = w._gpu.chip_id
                b, u = res.tpu_per_chip.get(chip, (0, 0))
                res.tpu_per_chip[chip] = (b + w.gpu_transfer_bytes,
                                          u + w.gpu_transfer_usec)
            else:  # a --gpuslice feeder without a device context
                for chip, (b2, u2) in w.gpu_per_chip.items():
                    b, u = res.tpu_per_chip.get(chip, (0, 0))
                    res.tpu_per_chip[chip] = (b + b2, u + u2)
            devices = [w._gpu.device] if w._gpu is not None else []
            for label in map(device_label, devices + w.slice_devices):
                if label not in res.devices:
                    res.devices.append(label)
        res.tpu_path_counters = sum_path_audit_counters(workers)
        stonewall_elapsed = [w.stonewall_elapsed_usec for w in workers
                             if w.stonewall_taken]
        res.first_done_usec = min(res.elapsed_usec_vec, default=0)
        if stonewall_elapsed:
            res.first_done_usec = min(stonewall_elapsed)
        res.last_done_usec = max(res.elapsed_usec_vec, default=0)
        return res

    def print_phase_results_table_header(self) -> None:
        print(f"{'OPERATION':<12}{'RESULT TYPE':<20}"
              f"{'FIRST DONE':>14}{'LAST DONE':>14}")
        print(f"{'=' * 11:<12}{'=' * 18:<20}{'=' * 12:>14}{'=' * 12:>14}")

    def print_phase_results(self, phase: BenchPhase) -> PhaseResults:
        res = self.generate_phase_results(phase)
        self._render_result_rows(res)
        if self.cfg.json_file_path:
            self._write_json(res)
        return res

    @staticmethod
    def _row(op: str, rtype: str, first, last) -> str:
        return f"{op:<12}{rtype + ' :':<20}{first:>14}{last:>14}"

    def _render_result_rows(self, res: PhaseResults) -> None:
        mib = 1 << 20
        first_s = res.first_done_usec / 1e6 or 1e-9
        last_s = res.last_done_usec / 1e6 or 1e-9
        rows = [self._row(res.phase_name, "Elapsed time",
                          _fmt_elapsed_usec(res.first_done_usec),
                          _fmt_elapsed_usec(res.last_done_usec))]
        if res.final["entries"]:
            rows.append(self._row(
                "", f"{res.entry_type}/s",
                f"{res.stonewall['entries'] / first_s:,.0f}",
                f"{res.final['entries'] / last_s:,.0f}"))
            rows.append(self._row(
                "", f"{res.entry_type} total",
                f"{res.stonewall['entries']}", f"{res.final['entries']}"))
        if res.final["iops"]:
            rows.append(self._row(
                "", "IOPS", f"{res.stonewall['iops'] / first_s:,.0f}",
                f"{res.final['iops'] / last_s:,.0f}"))
        if res.final["bytes"]:
            rows.append(self._row(
                "", "Throughput MiB/s",
                f"{res.stonewall['bytes'] / first_s / mib:,.0f}",
                f"{res.final['bytes'] / last_s / mib:,.0f}"))
            rows.append(self._row(
                "", "Total MiB",
                f"{res.stonewall['bytes'] / mib:,.0f}",
                f"{res.final['bytes'] / mib:,.0f}"))
        if res.tpu_bytes:
            rows.append(self._row("", "Device MiB/s", "-",
                                  f"{res.tpu_bytes / last_s / mib:,.0f}"))
            for chip, (b, _u) in sorted(res.tpu_per_chip.items()):
                rows.append(self._row("", f"  gpu {chip} MiB/s", "-",
                                      f"{b / last_s / mib:,.0f}"))
            tpu_ops = sum(res.tpu_path_counters.get(k, 0) for k in (
                "TpuH2dDirectOps", "TpuH2dStagedOps",
                "TpuD2hDirectOps", "TpuD2hStagedOps"))
            if tpu_ops:
                rows.append(self._row(
                    "", "Dev dispatch us/op", "-",
                    f"{res.tpu_dispatch_usec / tpu_ops:,.1f}"))
                rows.append(self._row(
                    "", "Dev copy us/op", "-",
                    f"{res.tpu_usec / tpu_ops:,.1f}"))
        counters = res.tpu_path_counters
        if counters.get("IciRedistMiB"):
            # the slice phase: shard ingest and the redistribution
            stripes = max(res.final["entries"], 1)
            rows.append(self._row("", "Shard ingest MiB", "-",
                                  f"{counters['ShardIngestMiB']:,}"))
            rows.append(self._row("", "Redist MiB", "-",
                                  f"{counters['IciRedistMiB']:,}"))
            rows.append(self._row(
                "", "Redist us/stripe", "-",
                f"{counters['IciRedistUSec'] / stripes:,.1f}"))
            rows.append(self._row("", "Redist Gbit/s hwm", "-",
                                  f"{counters['IciGbpsHwm']:,}"))
        for row in rows:
            print(row)

    def _result_record(self, res: PhaseResults) -> dict:
        mib = 1 << 20
        first_s = res.first_done_usec / 1e6 or 1e-9
        last_s = res.last_done_usec / 1e6 or 1e-9
        return {
            "ISODate": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            "Phase": res.phase_name,
            "EntryType": res.entry_type,
            "NumWorkers": res.num_workers,
            "ElapsedUSecFirst": res.first_done_usec,
            "ElapsedUSecLast": res.last_done_usec,
            "EntriesFirst": res.stonewall["entries"],
            "EntriesLast": res.final["entries"],
            "EntriesPerSecFirst": round(res.stonewall["entries"] / first_s, 2),
            "EntriesPerSecLast": round(res.final["entries"] / last_s, 2),
            "IOPSFirst": round(res.stonewall["iops"] / first_s, 2),
            "IOPSLast": round(res.final["iops"] / last_s, 2),
            "BytesFirst": res.stonewall["bytes"],
            "BytesLast": res.final["bytes"],
            "MiBPerSecFirst": round(res.stonewall["bytes"] / first_s / mib, 2),
            "MiBPerSecLast": round(res.final["bytes"] / last_s / mib, 2),
            "CPUUtilStoneWall": round(res.cpu_stonewall, 1),
            "CPUUtil": round(res.cpu_last_done, 1),
            "IOLatUSecMin": res.iops_histo.min_micro,
            "IOLatUSecAvg": round(res.iops_histo.avg_micro, 1),
            "IOLatUSecMax": res.iops_histo.max_micro,
            "IOLatUSecP99": round(res.iops_histo.percentile(99), 1),
            "EntLatUSecMin": res.entries_histo.min_micro,
            "EntLatUSecAvg": round(res.entries_histo.avg_micro, 1),
            "EntLatUSecMax": res.entries_histo.max_micro,
            "TpuHbmBytes": res.tpu_bytes,
            "TpuHbmMiBPerSec": round(res.tpu_bytes / last_s / mib, 2)
            if res.tpu_bytes else 0,
            "TpuDispatchUSec": res.tpu_dispatch_usec,
            "TpuTransferUSec": res.tpu_usec,
            "TpuPerChip": {str(k): {"Bytes": b, "USec": u}
                           for k, (b, u) in res.tpu_per_chip.items()},
            **res.tpu_path_counters,
            "Device": ", ".join(res.devices),
        }

    def _write_json(self, res: PhaseResults) -> None:
        """JSONL: one JSON object per phase result (consumed by
        tools/elbencho-tpu-summarize-json)."""
        rec = self._result_record(res)
        rec["Config"] = self.cfg.config_labels()
        rec["ElapsedUSecList"] = res.elapsed_usec_vec
        rec["IOLatHisto"] = res.iops_histo.to_dict()
        rec["EntLatHisto"] = res.entries_histo.to_dict()
        with open(self.cfg.json_file_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
