"""Statistics: live statistics during a phase, and the first-done/
last-done phase results and their output.

Reference: elbencho_tpu/stats/statistics.py (source/Statistics.{h,cpp}),
local runs only. During a phase: the live loop (the single console line,
the fullscreen per-worker view with its keys and its latency footer, the
--livecsv/--livejson streams). When it ends: the result table (with the
latency, CPU and worker-elapsed rows and the 0 us warning), the
--resfile copy of it, the --csvfile row and the --jsonfile record, with
the device keys and the path-audit counters.

JSON keys and CSV columns keep the JAX package's names, so records of
both packages compare key by key and the tools (elbencho-tpu-chart,
elbencho-tpu-summarize-json) read them; "Tpu" in a key means "the
device" (here a GPU, named in "Device").
"""

from __future__ import annotations

import json
import os
import sys
import time

from ..cuda.device import PATH_AUDIT_KEYS, sum_path_audit_counters
from ..phases import BenchPhase, phase_entry_type, phase_name
from ..workers.manager import WAIT_WAKEUP_SECS
from .cpu_util import CPUUtil
from .latency_histogram import LatencyHistogram

#: the shortest --liveint the loop renders at
LIVE_MIN_INTERVAL_MS = 50


def merge_live_latency_histos(workers) -> "tuple[LatencyHistogram, ...]":
    """(io, entries) histograms merged over a worker list for the
    fullscreen view's latency footer (the rwmix reads fold into io: a
    live view wants one op-latency distribution, not the result table's
    split)."""
    io_histo = LatencyHistogram()
    ent_histo = LatencyHistogram()
    for w in workers:
        io_histo.merge(w.iops_latency_histo)
        io_histo.merge(w.iops_latency_histo_rwmix)
        ent_histo.merge(w.entries_latency_histo)
    return io_histo, ent_histo


def _fmt_elapsed_usec(usec: int) -> str:
    secs = usec / 1_000_000
    if secs >= 60:
        m, s = divmod(secs, 60)
        return f"{int(m)}m{s:.1f}s"
    if secs >= 1:
        return f"{secs:.3f}s"
    return f"{usec / 1000:.2f}ms"


#: fixed result columns of the CSV schema, the JAX package's
#: (docs/result-columns.md), by name and in order; config labels follow
CSV_RESULT_COLUMNS = (
    "ISODate", "Label", "Phase", "EntryType", "NumWorkers",
    "ElapsedUSecFirst", "ElapsedUSecLast", "EntriesFirst", "EntriesLast",
    "EntriesPerSecFirst", "EntriesPerSecLast", "IOPSFirst", "IOPSLast",
    "BytesFirst", "BytesLast", "MiBPerSecFirst", "MiBPerSecLast",
    "CPUUtilStoneWall", "CPUUtil", "IOLatUSecMin", "IOLatUSecAvg",
    "IOLatUSecMax", "IOLatUSecP99", "EntLatUSecMin", "EntLatUSecAvg",
    "EntLatUSecMax", "TpuHbmBytes", "TpuHbmMiBPerSec",
    "TpuDispatchUSec", "TpuTransferUSec", "NumHostsDegraded",
    "RWMixReadIOPSLast", "RWMixReadMiBPerSecLast",
    "Scenario", "ScenarioStep", "EpochRateMiBs")

#: the CSV columns of features the port lacks (service hosts,
#: scenarios), with what the JAX package writes when each is off; they
#: are not in the port's JSON record
CSV_FEATURE_OFF_COLUMNS = {
    "NumHostsDegraded": 0, "Scenario": "", "ScenarioStep": "",
    "EpochRateMiBs": 0}


def _counts() -> dict:
    return {"entries": 0, "bytes": 0, "iops": 0}


def _add_counts(totals: dict, ops) -> None:
    """Add one LiveOps to an {entries, bytes, iops} dict."""
    totals["entries"] += ops.num_entries_done
    totals["bytes"] += ops.num_bytes_done
    totals["iops"] += ops.num_iops_done


class PhaseResults:
    """Aggregated first-done/last-done numbers for one finished phase."""

    def __init__(self):
        self.phase: BenchPhase = BenchPhase.IDLE
        self.phase_name = ""
        self.entry_type = "files"
        self.first_done_usec = 0
        self.last_done_usec = 0
        self.stonewall = _counts()
        self.final = _counts()
        # the reads of a write phase (--rwmixpct, --rwmixthr)
        self.stonewall_rwmix = _counts()
        self.final_rwmix = _counts()
        self.iops_histo = LatencyHistogram()
        self.entries_histo = LatencyHistogram()
        self.iops_histo_rwmix = LatencyHistogram()
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
        self._live_csv_fh = None
        self._live_json_fh = None
        self._live_rows = 0      # data rows written to the live streams
        self._live_started = 0.0
        self._fullscreen_active = False
        self._fs_scroll = 0
        self._fs_old_termios = None
        # the live --cpu column's own meter: the JAX package reads the
        # phase's meter there, so each render moved the first- and
        # last-done baselines and CPU util % covered only the time since
        # the last render
        self._live_cpu = CPUUtil()

    # ------------------------------------------------------------------
    # live statistics (reference: printLiveStats, Statistics.cpp:1337)
    # ------------------------------------------------------------------

    def _sum_live_ops(self) -> "tuple[int, int, int, int, list]":
        """(entries, bytes, iops, workers done, [(rank, LiveOps)]) from one
        snapshot of each worker's counters, the rwmix reads added, so
        that a row's per-worker counters add up to its totals. The JAX
        package reads the running counters again for the per-worker part
        of a --livejsonex row, and without the rwmix reads, so that they
        disagreed when a worker booked an op in between or read in a
        write phase."""
        per_worker = []
        for w in self.manager.workers:
            ops = w.live_ops.snapshot()
            mixed = w.live_ops_rwmix_read
            ops.num_entries_done += mixed.num_entries_done
            ops.num_bytes_done += mixed.num_bytes_done
            ops.num_iops_done += mixed.num_iops_done
            per_worker.append((w.rank, ops))
        entries = sum(ops.num_entries_done for _rank, ops in per_worker)
        num_bytes = sum(ops.num_bytes_done for _rank, ops in per_worker)
        iops = sum(ops.num_iops_done for _rank, ops in per_worker)
        done = self.manager.shared.num_workers_done \
            + self.manager.shared.num_workers_done_with_error
        return entries, num_bytes, iops, done, per_worker

    def live_stats_loop(self, phase: BenchPhase, phase_start: float) -> None:
        """Poll the workers' counters until the phase completes, checking
        --timelimit and a worker's error on every poll, and render every
        --liveint: the console line or the fullscreen view (unless
        --nolive) and the live files. Runs on the coordinator thread.

        Renders fall on a fixed grid of --liveint from the loop's start
        (a slot missed behind a long poll is skipped), so a phase gets one
        row per --liveint of its length. The JAX package counts each
        interval from the poll that rendered the last row: its rows come
        late by up to a poll each and the delay adds up (a 4 s phase at
        --liveint 250 got 15 rows where the grid gives 16). Each row's
        rate divides by the measured time in both."""
        cfg = self.cfg
        interval = max(cfg.live_stats_interval_ms,
                       LIVE_MIN_INTERVAL_MS) / 1000.0
        use_line = not cfg.disable_live_stats
        is_tty = sys.stdout.isatty()
        self._live_started = time.monotonic()
        self._live_cpu.update()  # baseline for the first render
        last_bytes = last_iops = 0
        last_t = self._live_started
        next_render = self._live_started + interval
        while not self.manager.all_workers_done():
            time.sleep(WAIT_WAKEUP_SECS)
            self.manager.check_phase_time_limit(phase_start)
            self.manager.check_fail_fast_interrupt()
            now = time.monotonic()
            if now < next_render:
                continue
            while next_render <= now:
                next_render += interval
            entries, num_bytes, iops, done, per_worker = \
                self._sum_live_ops()
            dt = max(now - last_t, 1e-9)
            bps = (num_bytes - last_bytes) / dt
            ops_per_s = (iops - last_iops) / dt
            last_bytes, last_iops, last_t = num_bytes, iops, now
            elapsed = int(now - self._live_started)
            # the live files are written with the console output off too
            self._write_live_files(phase, entries, num_bytes, iops, elapsed,
                                   per_worker)
            if not use_line:
                continue
            unit, div = ("MB", 1000 ** 2) if cfg.use_base10_units \
                else ("MiB", 1 << 20)
            fullscreen = (is_tty and not cfg.use_single_line_live_stats
                          and not cfg.single_line_live_stats_no_erase)
            if fullscreen:
                self._render_fullscreen(phase, elapsed, bps / div,
                                        ops_per_s, unit, div, done)
                continue
            line = (f"{phase_name(phase)}: {elapsed}s; "
                    f"{bps / div:,.0f} {unit}/s; "
                    f"{ops_per_s:,.0f} IOPS; {entries} entries; "
                    f"{num_bytes / div:,.0f} {unit} total; "
                    f"{done}/{len(self.manager.workers)} done")
            if cfg.show_cpu_util:
                line += f"; CPU {self._live_cpu.update():.0f}%"
            if is_tty and not cfg.single_line_live_stats_no_erase:
                print("\r\x1b[2K" + line, end="", flush=True)
            else:
                print(line, flush=True)
        if use_line and is_tty:
            if self._fullscreen_active:
                print("\x1b[2J\x1b[H", end="", flush=True)
                self._fullscreen_active = False
                self._exit_fullscreen_keys()
            elif not cfg.single_line_live_stats_no_erase:
                print("\r\x1b[2K", end="", flush=True)

    #: worker rows per fullscreen frame when the terminal size is unknown
    _FS_ROWS = 40
    #: header and footer lines around the worker table
    _FS_CHROME_LINES = 6
    #: this frame's worker rows (read from the terminal once per frame)
    _fs_rows = _FS_ROWS

    def _term_fs_rows(self) -> int:
        """Worker rows that fit the terminal now (follows resizes)."""
        import shutil
        lines = shutil.get_terminal_size(fallback=(80, 0)).lines
        return max(lines - self._FS_CHROME_LINES, 4) if lines \
            else self._FS_ROWS

    def _render_fullscreen(self, phase, elapsed, rate, ops_per_s, unit,
                           div, done) -> None:
        """Fullscreen per-worker live table (ANSI; the reference draws it
        with ftxui, Statistics.cpp:716-1249). The arrow keys, PgUp, PgDn,
        Home, End and j/k/g/G scroll the worker rows."""
        cfg = self.cfg
        workers = self.manager.workers
        self._fs_rows = self._term_fs_rows()  # one size for the frame
        self._poll_fullscreen_keys(len(workers))
        scroll = self._fs_scroll
        lines = [
            f"Phase: {phase_name(phase)}   Elapsed: {elapsed}s   "
            f"Done: {done}/{len(workers)}",
            f"Total: {rate:,.0f} {unit}/s  {ops_per_s:,.0f} IOPS"
            + (f"  CPU: {self._live_cpu.update():.0f}%"
               if cfg.show_cpu_util else ""),
            "",
            f"{'Rank':>6} {'Entries':>10} {unit:>10} {'IOPS':>12} "
            f"{'State':>8}"]
        window = workers[scroll:scroll + self._fs_rows]
        for w in window:
            state = "done" if w.phase_finished else "run"
            lines.append(
                f"{w.rank:>6} {w.live_ops.num_entries_done:>10} "
                f"{w.live_ops.num_bytes_done / div:>10,.0f} "
                f"{w.live_ops.num_iops_done:>12,} {state:>8}")
        if len(workers) > len(window):
            lines.append(f"... showing {scroll}..{scroll + len(window) - 1} "
                         f"of {len(workers)} workers (arrow keys / PgUp / "
                         f"PgDn scroll)")
        # the running tail of the op latencies; a phase that moves no
        # blocks (mkdirs, stat, deletes) shows its entry latencies
        io_histo, ent_histo = merge_live_latency_histos(workers)
        tail_histo, tail_label = ((io_histo, "IO") if any(io_histo.buckets)
                                  else (ent_histo, "Entry"))
        if any(tail_histo.buckets):
            lines.append(
                f"{tail_label} lat us: "
                f"p50={tail_histo.percentile(50):,.0f}  "
                f"p99={tail_histo.percentile(99):,.0f}  "
                f"p99.9={tail_histo.percentile(99.9):,.0f}  "
                f"max={tail_histo.max_micro:,}")
        frame = "\x1b[H" + "\x1b[2K" + "\n\x1b[2K".join(lines) + "\x1b[J"
        if not self._fullscreen_active:
            print("\x1b[2J", end="")
            self._fullscreen_active = True
            self._enter_fullscreen_keys()
        print(frame, end="", flush=True)

    def _enter_fullscreen_keys(self) -> None:
        """Put a terminal stdin into cbreak mode, so that keys arrive
        without Enter; close() and _exit_fullscreen_keys restore it."""
        self._fs_scroll = 0
        self._fs_old_termios = None
        try:
            import termios
            import tty
            if sys.stdin.isatty():
                fd = sys.stdin.fileno()
                self._fs_old_termios = (fd, termios.tcgetattr(fd))
                tty.setcbreak(fd)
        except (ImportError, OSError):
            pass

    def _exit_fullscreen_keys(self) -> None:
        old = self._fs_old_termios
        if old is not None:
            try:
                import termios
                termios.tcsetattr(old[0], termios.TCSADRAIN, old[1])
            except (ImportError, OSError):
                pass
            self._fs_old_termios = None

    def _poll_fullscreen_keys(self, num_workers: int) -> None:
        """Read the pending keys without blocking and move the window over
        the worker rows."""
        if self._fs_old_termios is None:
            return
        import select
        scroll = self._fs_scroll
        max_scroll = max(num_workers - self._fs_rows, 0)
        buf = b""
        try:
            while select.select([sys.stdin], [], [], 0)[0]:
                chunk = os.read(sys.stdin.fileno(), 64)
                if not chunk:
                    break
                buf += chunk
        except OSError:
            pass
        # key by key: auto-repeat delivers several sequences in one read
        i = 0
        while i < len(buf):
            seq, step = self._match_key_seq(buf[i:])
            i += step
            if seq in ("up", "k"):
                scroll -= 1
            elif seq in ("down", "j"):
                scroll += 1
            elif seq in ("pgup", "\x02"):
                scroll -= self._fs_rows
            elif seq in ("pgdn", "\x06"):
                scroll += self._fs_rows
            elif seq in ("home", "g"):
                scroll = 0
            elif seq in ("end", "G"):
                scroll = max_scroll
        self._fs_scroll = min(max(scroll, 0), max_scroll)

    _ESC_SEQS = {b"\x1b[A": "up", b"\x1b[B": "down", b"\x1b[5~": "pgup",
                 b"\x1b[6~": "pgdn", b"\x1b[H": "home", b"\x1b[F": "end"}

    @classmethod
    def _match_key_seq(cls, buf: bytes) -> "tuple[str, int]":
        """The key at the front of buf -> (name, bytes consumed)."""
        if buf[:1] == b"\x1b":
            for seq, name in cls._ESC_SEQS.items():
                if buf.startswith(seq):
                    return name, len(seq)
            return "", 1  # an unknown escape: skip the ESC byte
        return chr(buf[0]), 1

    def _write_live_files(self, phase, entries, num_bytes, iops, elapsed,
                          per_worker) -> None:
        """One row of totals to --livecsv and --livejson (the JSON row
        with each worker's counters of `per_worker`, [(rank, LiveOps)],
        under --livejsonex or --livecsvex).
        The CSV escapes the label's commas to ';', as the result CSV
        does: the JAX package writes it raw, so a label with a comma gave
        a row wider than its header."""
        cfg = self.cfg
        if cfg.live_csv_file_path:
            if self._live_csv_fh is None:
                self._live_csv_fh = (sys.stdout
                                     if cfg.live_csv_file_path == "stdout"
                                     else open(cfg.live_csv_file_path, "a"))
                print("ISODate,Label,Phase,Seconds,Entries,Bytes,IOPS",
                      file=self._live_csv_fh, flush=True)
            label = cfg.bench_label.replace(",", ";")
            print(f"{time.strftime('%Y-%m-%dT%H:%M:%S')},"
                  f"{label},{phase_name(phase)},{elapsed},"
                  f"{entries},{num_bytes},{iops}",
                  file=self._live_csv_fh, flush=True)
        if cfg.live_json_file_path:
            if self._live_json_fh is None:
                self._live_json_fh = (sys.stdout
                                      if cfg.live_json_file_path == "stdout"
                                      else open(cfg.live_json_file_path, "a"))
            rec = {"ISODate": time.strftime("%Y-%m-%dT%H:%M:%S"),
                   "Label": cfg.bench_label, "Phase": phase_name(phase),
                   "Seconds": elapsed, "Entries": entries,
                   "Bytes": num_bytes, "IOPS": iops}
            if cfg.live_json_extended or cfg.live_csv_extended:
                rec["Workers"] = [{"Rank": rank, **ops.as_dict()}
                                  for rank, ops in per_worker]
            print(json.dumps(rec), file=self._live_json_fh, flush=True)
        if cfg.live_csv_file_path or cfg.live_json_file_path:
            self._live_rows += 1
        self._flush_live_files()

    def _flush_live_files(self) -> None:
        """Push the live streams to stable storage every interval, so a
        tailer on another host of a network file system sees each row;
        best effort (stdout and pipes have no fsync)."""
        for fh in (self._live_csv_fh, self._live_json_fh):
            if fh is None:
                continue
            try:
                fh.flush()
                os.fsync(fh.fileno())
            except (OSError, ValueError):
                pass

    def close(self) -> None:
        """Restore the terminal and close the live files."""
        self._exit_fullscreen_keys()
        for fh in (self._live_csv_fh, self._live_json_fh):
            if fh is not None and fh is not sys.stdout:
                fh.close()
        self._live_csv_fh = self._live_json_fh = None

    def abort_cleanup(self) -> None:
        """An aborted run: close the live streams and remove live files
        that hold no data row, so that a run after it finds no stale
        header-only file."""
        self.close()
        if self._live_rows:
            return  # real data: keep the files
        for path in (self.cfg.live_csv_file_path,
                     self.cfg.live_json_file_path):
            if not path or path == "stdout":
                continue
            try:
                # the streams append: an earlier run's rows may be in the
                # file, so only an empty or header-only file goes
                with open(path) as f:
                    head = f.readline()
                    more = f.readline()
                if more or (head and not head.startswith("ISODate")):
                    continue
                os.unlink(path)
            except OSError:
                pass

    # ------------------------------------------------------------------
    # phase results (reference: printPhaseResults :1619 /
    # generatePhaseResults :1695)
    # ------------------------------------------------------------------

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
            _add_counts(res.stonewall, w.stonewall_ops)
            _add_counts(res.final, w.live_ops)
            _add_counts(res.stonewall_rwmix, w.stonewall_ops_rwmix_read)
            _add_counts(res.final_rwmix, w.live_ops_rwmix_read)
            res.iops_histo.merge(w.iops_latency_histo)
            res.entries_histo.merge(w.entries_latency_histo)
            res.iops_histo_rwmix.merge(w.iops_latency_histo_rwmix)
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
        line = (f"{'OPERATION':<12}{'RESULT TYPE':<20}"
                f"{'FIRST DONE':>14}{'LAST DONE':>14}")
        print(line)
        print(f"{'=' * 11:<12}{'=' * 18:<20}{'=' * 12:>14}{'=' * 12:>14}")
        self._print_to_res_file(line)

    def print_phase_results(self, phase: BenchPhase) -> PhaseResults:
        res = self.generate_phase_results(phase)
        self._render_result_rows(res)
        # one record for both files: a CSV row equals its JSON record
        rec = self._result_record(res)
        if self.cfg.csv_file_path:
            self._write_csv(dict(rec))
        if self.cfg.json_file_path:
            self._write_json(res, rec)
        return res

    @staticmethod
    def _row(op: str, rtype: str, first, last) -> str:
        return f"{op:<12}{rtype + ' :':<20}{first:>14}{last:>14}"

    def _render_result_rows(self, res: PhaseResults) -> None:
        cfg = self.cfg
        unit, div = ("MB", 1000 ** 2) if cfg.use_base10_units \
            else ("MiB", 1 << 20)
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
                "", f"Throughput {unit}/s",
                f"{res.stonewall['bytes'] / first_s / div:,.0f}",
                f"{res.final['bytes'] / last_s / div:,.0f}"))
            rows.append(self._row(
                "", f"Total {unit}",
                f"{res.stonewall['bytes'] / div:,.0f}",
                f"{res.final['bytes'] / div:,.0f}"))
        if res.final_rwmix["iops"]:
            rows.append(self._row(
                "", "Read IOPS (rwmix)",
                f"{res.stonewall_rwmix['iops'] / first_s:,.0f}",
                f"{res.final_rwmix['iops'] / last_s:,.0f}"))
            rows.append(self._row(
                "", f"Read {unit}/s (rwmix)",
                f"{res.stonewall_rwmix['bytes'] / first_s / div:,.0f}",
                f"{res.final_rwmix['bytes'] / last_s / div:,.0f}"))
        if res.tpu_bytes:
            rows.append(self._row("", f"Device {unit}/s", "-",
                                  f"{res.tpu_bytes / last_s / div:,.0f}"))
            for chip, (b, _u) in sorted(res.tpu_per_chip.items()):
                rows.append(self._row("", f"  gpu {chip} {unit}/s", "-",
                                      f"{b / last_s / div:,.0f}"))
            tpu_ops = sum(res.tpu_path_counters.get(k, 0) for k in (
                "TpuH2dDirectOps", "TpuH2dStagedOps",
                "TpuD2hDirectOps", "TpuD2hStagedOps"))
            if tpu_ops and (res.tpu_dispatch_usec or res.tpu_usec):
                rows.append(self._row(
                    "", "Dev dispatch us/op", "-",
                    f"{res.tpu_dispatch_usec / tpu_ops:,.1f}"))
                rows.append(self._row(
                    "", "Dev copy us/op", "-",
                    f"{res.tpu_usec / tpu_ops:,.1f}"))
        if cfg.show_cpu_util:
            rows.append(self._row("", "CPU util %",
                                  f"{res.cpu_stonewall:.0f}",
                                  f"{res.cpu_last_done:.0f}"))
        if cfg.show_latency and res.iops_histo.num_values:
            h = res.iops_histo
            rows.append(f"{'':12}{'IO latency us :':<20}"
                        f"min={h.min_micro} avg={h.avg_micro:.0f} "
                        f"max={h.max_micro}")
        if cfg.show_latency and res.entries_histo.num_values:
            h = res.entries_histo
            rows.append(f"{'':12}{'Ent latency us :':<20}"
                        f"min={h.min_micro} avg={h.avg_micro:.0f} "
                        f"max={h.max_micro}")
        if cfg.show_latency_percentiles and res.iops_histo.num_values:
            nines = res.iops_histo.percentiles_nines(
                cfg.num_latency_percentile_9s)
            txt = " ".join(f"{k}={v:.0f}" for k, v in nines.items())
            rows.append(f"{'':12}{'IO lat pcts :':<20}{txt}")
        if cfg.show_latency_histogram and res.iops_histo.num_values:
            rows.append(f"{'':12}IO lat histogram : "
                        f"{res.iops_histo.histogram_str()}")
        if cfg.show_all_elapsed:
            txt = ", ".join(_fmt_elapsed_usec(u)
                            for u in sorted(res.elapsed_usec_vec))
            rows.append(f"{'':12}Worker elapsed   : {txt}")
        if not cfg.ignore_0usec_errors and res.num_workers \
                and res.first_done_usec == 0:
            # reference semantics (Statistics.cpp:2186): warn when the
            # fastest worker finished in 0 microseconds — the whole phase
            # was too short to measure
            rows.append(
                f"{'':12}WARNING: phase completed in 0 microseconds; "
                f"results may be bogus (too little work?). --no0usecerr "
                f"silences this.")
        for row in rows:
            print(row)
            self._print_to_res_file(row)

    def _print_to_res_file(self, line: str) -> None:
        if self.cfg.res_file_path:
            with open(self.cfg.res_file_path, "a") as f:
                f.write(line + "\n")

    def _result_record(self, res: PhaseResults) -> dict:
        mib = 1 << 20
        first_s = res.first_done_usec / 1e6 or 1e-9
        last_s = res.last_done_usec / 1e6 or 1e-9
        return {
            "ISODate": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            "Label": self.cfg.bench_label,
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
            "RWMixReadIOPSLast": round(res.final_rwmix["iops"] / last_s, 2),
            "RWMixReadMiBPerSecLast": round(
                res.final_rwmix["bytes"] / last_s / mib, 2),
        }

    @classmethod
    def check_csv_file_compatibility(cls, cfg) -> None:
        """Appending to an existing CSV requires a matching column count
        (reference: checkCSVFileCompatibility, ProgArgs.cpp:4303 — catches
        files written by another version, the JAX package or other label
        settings before any phase runs). A defaulted file is rotated to a
        fresh suffixed name instead. Raises ValueError on mismatch."""
        path = cfg.csv_file_path
        if not path or not os.path.exists(path) \
                or os.path.getsize(path) == 0:
            return
        found = cls._csv_commas(path)
        labels = 0 if cfg.no_csv_labels else len(cfg.config_labels())
        expected = len(CSV_RESULT_COLUMNS) + labels - 1
        if found == expected:
            return
        if cfg._defaulted_csv:
            base, ext = os.path.splitext(path)
            for n in range(2, 1000):
                candidate = f"{base}_{n}{ext}"
                if not os.path.exists(candidate) \
                        or os.path.getsize(candidate) == 0 \
                        or cls._csv_commas(candidate) == expected:
                    from ..toolkits.logger import log
                    log(0, f"NOTE: default CSV result file {path} has an "
                           f"incompatible column count (old version?); "
                           f"writing to {candidate} instead")
                    cfg.csv_file_path = candidate
                    return
        raise ValueError(
            f"CSV output file exists and the column compatibility "
            f"check failed (was it written by a different version or "
            f"with different label settings?). Found commas: {found}; "
            f"expected: {expected}; file: {path}")

    @staticmethod
    def _csv_commas(path: str) -> int:
        """The commas of the CSV file's header line."""
        with open(path) as f:
            return f.readline().rstrip("\n").count(",")

    def _write_csv(self, rec: dict) -> None:
        """Append the phase's row (and the header to a new file): the
        record's CSV columns, then the config labels. TpuPerChip, Device
        and the path-audit counters are JSON-only, as in the JAX
        package."""
        assert (set(rec) - {"TpuPerChip", "Device", *PATH_AUDIT_KEYS}
                == set(CSV_RESULT_COLUMNS) - set(CSV_FEATURE_OFF_COLUMNS)), \
            "CSV schema drift"
        rec = {col: CSV_FEATURE_OFF_COLUMNS[col]
               if col in CSV_FEATURE_OFF_COLUMNS else rec[col]
               for col in CSV_RESULT_COLUMNS}
        labels = {} if self.cfg.no_csv_labels else self.cfg.config_labels()
        path = self.cfg.csv_file_path
        new_file = not os.path.exists(path) or os.path.getsize(path) == 0
        with open(path, "a") as f:
            if new_file:
                f.write(",".join(list(rec) + list(labels)) + "\n")
            # comma-escape EVERY value (Label is user-supplied) so the
            # fixed column count the compatibility check relies on holds
            vals = [str(v).replace(",", ";")
                    for v in list(rec.values()) + list(labels.values())]
            f.write(",".join(vals) + "\n")

    def _write_json(self, res: PhaseResults, rec: dict) -> None:
        """JSONL: one JSON object per phase result (consumed by
        tools/elbencho-tpu-summarize-json)."""
        rec["Config"] = self.cfg.config_labels()
        rec["ElapsedUSecList"] = res.elapsed_usec_vec
        rec["IOLatHisto"] = res.iops_histo.to_dict()
        rec["EntLatHisto"] = res.entries_histo.to_dict()
        with open(self.cfg.json_file_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
