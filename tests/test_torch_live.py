"""Live statistics of the port (device="cpu") against the JAX package's:
the live files (--livecsv, --livejson, --livecsvex, --livejsonex), the
console line (--live1, --live1n, --base10, --cpu), the fullscreen view
and its keys, the live CPU meter, run control with live statistics on,
and an end-to-end run of each package's CLI.

Where no clock is involved the outputs are compared byte for byte: both
packages' statistics modules are fed one fake clock (``time`` patched in
each module), one numpy-made counter sequence and, for --cpu, one
/proc/stat sequence. Two faults of the JAX package are not kept, and a
test pins each: the live CSV writes a label's commas raw, and the live
--cpu column reads the phase's CPU meter, so it moves the first- and
last-done CPU use. The render cadence is a departure the port chose,
not a fault of the JAX package: the port renders on a fixed --liveint
grid, the JAX package counts each interval from the poll that rendered
the last row. The two agree where the polls land on the grid, so the
fake clock's tick (1/64 s) divides every interval compared byte for
byte, and one test pins where they part.
"""

import fcntl
import json
import os
import pty
import select
import shutil
import signal
import struct
import subprocess
import sys
import termios
import time
import types

import numpy as np
import pytest
import torch

import elbencho_tpu.config.args as jax_args_mod
import elbencho_tpu_torch.config.args as port_args_mod
from elbencho_tpu.cli import main as jax_main
from elbencho_tpu.stats import statistics as jax_stats
from elbencho_tpu.stats.cpu_util import CPUUtil as JaxCPUUtil
from elbencho_tpu.stats.latency_histogram import \
    LatencyHistogram as JaxLatencyHistogram
from elbencho_tpu.workers.base import LiveOps as JaxLiveOps
from elbencho_tpu_torch.cli import main as port_main
from elbencho_tpu_torch.phases import BenchPhase
from elbencho_tpu_torch.stats import statistics as port_stats
from elbencho_tpu_torch.stats.cpu_util import CPUUtil
from elbencho_tpu_torch.stats.latency_histogram import LatencyHistogram
from elbencho_tpu_torch.workers.base import LiveOps
from test_torch_dirmode import jax_args, records, run_jax, run_port
from test_torch_e2e import _jax_python_loop  # noqa: F401
from test_torch_runcontrol import PORT_CHILD, SLACK_S, spawn, wait_for

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": (jax_stats, jax_args_mod, JaxLiveOps, JaxLatencyHistogram,
                    JaxCPUUtil),
            "port": (port_stats, port_args_mod, LiveOps, LatencyHistogram,
                     CPUUtil)}
ISO_DATE = "2026-10-17T12:00:00"
#: the fake clock's step for each of the live loops' 20 ms polls: a
#: binary fraction, so that every time and every sum of --liveint is
#: exact in both packages' float arithmetic
TICK = 1 / 64
CSV_HEADER = "ISODate,Label,Phase,Seconds,Entries,Bytes,IOPS"


# ----------------------------------------------------------------------
# a fake clock, fake workers and a fake manager, one set per package
# ----------------------------------------------------------------------

class FakeClock:
    """The ``time`` of a statistics module: each poll's sleep() advances
    it by one tick and then runs the scripted events of that tick."""

    def __init__(self, on_tick=None, tick=TICK):
        self.ticks = 0
        self.tick = tick
        self.on_tick = on_tick or (lambda n: None)

    def monotonic(self):
        return self.ticks * self.tick

    def sleep(self, secs):
        assert secs == 0.02
        self.ticks += 1
        self.on_tick(self.ticks)

    @staticmethod
    def strftime(fmt, *_args):
        assert fmt == "%Y-%m-%dT%H:%M:%S"
        return ISO_DATE


def fake_worker(pkg, rank):
    _stats, _args, live_ops_cls, histo_cls, _cpu = PACKAGES[pkg]
    w = types.SimpleNamespace(
        rank=rank, live_ops=live_ops_cls(), phase_finished=False,
        iops_latency_histo=histo_cls(), entries_latency_histo=histo_cls(),
        live_ops_rwmix_read=live_ops_cls(),
        iops_latency_histo_rwmix=histo_cls())
    return w


class FakeManager:
    """What the live loop reads of a WorkerManager: the workers, the done
    counts, the JAX package's phase CPU meter, and the per-poll checks."""

    def __init__(self, pkg, num_workers):
        self.workers = [fake_worker(pkg, r) for r in range(num_workers)]
        self.shared = types.SimpleNamespace(
            num_workers_done=0, num_workers_done_with_error=0,
            cpu_util=PACKAGES[pkg][4]())
        self.polls = 0

    def all_workers_done(self):
        return self.shared.num_workers_done \
            + self.shared.num_workers_done_with_error >= len(self.workers)

    def check_phase_time_limit(self, _phase_start):
        self.polls += 1

    def check_fail_fast_interrupt(self):
        pass


def make_stats(pkg, manager, monkeypatch, clock, **cfg_kwargs):
    stats_mod, args_mod = PACKAGES[pkg][:2]
    monkeypatch.setattr(stats_mod, "time", clock)
    cfg = args_mod.BenchConfig(**cfg_kwargs)
    return stats_mod.Statistics(cfg, manager)


def counter_steps(seed, ticks, workers):
    """(ticks, workers, 3) increments of (entries, bytes, iops)."""
    rng = np.random.default_rng(seed)
    steps = np.zeros((ticks, workers, 3), dtype=np.int64)
    ops = rng.integers(0, 4, size=(ticks, workers))
    steps[:, :, 0] = rng.integers(0, 2, size=(ticks, workers))
    steps[:, :, 1] = ops * (1 << 20)
    steps[:, :, 2] = ops
    return steps


def apply_step(manager, step):
    for w, (entries, num_bytes, iops) in zip(manager.workers, step,
                                             strict=True):
        w.live_ops.num_entries_done += int(entries)
        w.live_ops.num_bytes_done += int(num_bytes)
        w.live_ops.num_iops_done += int(iops)


# ----------------------------------------------------------------------
# (a) the live files
# ----------------------------------------------------------------------

def write_rows(pkg, tmp_path, monkeypatch, label, csv_path, json_path,
               **flags):
    steps = counter_steps(7, 3, 3)
    manager = FakeManager(pkg, 3)
    stats = make_stats(pkg, manager, monkeypatch, FakeClock(),
                       live_csv_file_path=csv_path,
                       live_json_file_path=json_path, bench_label=label,
                       **flags)
    for i, phase in enumerate((BenchPhase.CREATEFILES, BenchPhase.READFILES,
                               BenchPhase.READFILES)):
        apply_step(manager, steps[i])
        entries, num_bytes, iops, _done, *per_worker = stats._sum_live_ops()
        stats._write_live_files(phase, entries, num_bytes, iops, i,
                                *per_worker)
    stats.close()
    return stats


@pytest.mark.parametrize("flags", [{}, {"live_json_extended": True},
                                   {"live_csv_extended": True}],
                         ids=["totals", "livejsonex", "livecsvex"])
def test_live_files_equal_the_jax_package(tmp_path, monkeypatch, flags):
    out = {}
    for pkg in PACKAGES:
        csv_path, json_path = tmp_path / f"{pkg}.csv", tmp_path / f"{pkg}.json"
        stats = write_rows(pkg, tmp_path, monkeypatch, "run 1",
                           str(csv_path), str(json_path), **flags)
        assert stats._live_rows == 3
        out[pkg] = (csv_path.read_bytes(), json_path.read_bytes())
    assert out["port"] == out["jax"]
    csv_lines = out["port"][0].decode().splitlines()
    assert csv_lines[0] == CSV_HEADER and len(csv_lines) == 4
    assert csv_lines[1].startswith(f"{ISO_DATE},run 1,WRITE,0,")
    rows = [json.loads(line) for line in out["port"][1].splitlines()]
    assert [r["Phase"] for r in rows] == ["WRITE", "READ", "READ"]
    # --livecsvex adds the Workers to the JSON rows only (a quirk kept)
    assert all(("Workers" in r) == bool(flags) for r in rows)
    for r in rows:
        for key, per_worker in (("Entries", "NumEntriesDone"),
                                ("Bytes", "NumBytesDone"),
                                ("IOPS", "NumIOPSDone")):
            if flags:
                assert sum(w[per_worker] for w in r["Workers"]) == r[key]


def test_live_files_to_stdout_equal_the_jax_package(tmp_path, monkeypatch,
                                                    capsys):
    out = {}
    for pkg in PACKAGES:
        write_rows(pkg, tmp_path, monkeypatch, "run 1", "stdout", "stdout",
                   live_json_extended=True)
        out[pkg] = capsys.readouterr().out
    assert out["port"] == out["jax"]
    lines = out["port"].splitlines()
    assert lines[0] == CSV_HEADER and len(lines) == 7  # 3 CSV + 3 JSON


def test_a_label_with_a_comma_keeps_the_live_csv_columns(tmp_path,
                                                         monkeypatch):
    """The fault not kept: the JAX package writes the label raw, so its
    row has one column more than its header; the port escapes ',' to ';'
    as its result CSV does. The JSON rows keep the label as given."""
    out = {}
    for pkg in PACKAGES:
        csv_path, json_path = tmp_path / f"{pkg}.csv", tmp_path / f"{pkg}.json"
        write_rows(pkg, tmp_path, monkeypatch, "live,1", str(csv_path),
                   str(json_path))
        out[pkg] = (csv_path.read_text().splitlines(), json_path.read_bytes())
    jax_csv, port_csv = out["jax"][0], out["port"][0]
    assert out["port"][1] == out["jax"][1]
    assert [len(line.split(",")) for line in jax_csv] == [7, 8, 8, 8]
    assert [len(line.split(",")) for line in port_csv] == [7, 7, 7, 7]
    assert port_csv == [line.replace("live,1", "live;1") for line in jax_csv]


def racing_live_ops(live_ops_cls):
    """A LiveOps whose bytes move on by 1 MiB at every read, as a
    worker's do while the live loop reads them."""

    class Racing(live_ops_cls):
        def __init__(self):
            self._reads = 0
            super().__init__()

        @property
        def num_bytes_done(self):
            self._reads += 1
            return self._reads << 20

        @num_bytes_done.setter
        def num_bytes_done(self, _value):
            pass

    return Racing


def test_a_rows_workers_add_up_while_the_counters_move(tmp_path,
                                                       monkeypatch):
    """The fault not kept: the JAX package sums the running counters for
    a --livejsonex row's totals and reads them again for its Workers, so
    a worker that booked an op in between makes the two disagree (found
    by chip_smoke.py's live pass, --gpudirect through the Python loop);
    the port takes one snapshot of each worker's counters for both."""
    got = {}
    for pkg in PACKAGES:
        manager = FakeManager(pkg, 3)
        for w in manager.workers:
            w.live_ops = racing_live_ops(PACKAGES[pkg][2])()
        json_path = tmp_path / f"{pkg}.json"
        stats = make_stats(pkg, manager, monkeypatch, FakeClock(),
                           live_json_file_path=str(json_path),
                           live_json_extended=True)
        entries, num_bytes, iops, _done, *per_worker = stats._sum_live_ops()
        stats._write_live_files(BenchPhase.READFILES, entries, num_bytes,
                                iops, 0, *per_worker)
        stats.close()
        row = json.loads(json_path.read_text())
        got[pkg] = (row["Bytes"],
                    sum(w["NumBytesDone"] for w in row["Workers"]))
    assert got == {"jax": (3 << 20, 6 << 20), "port": (3 << 20, 3 << 20)}


# ----------------------------------------------------------------------
# (b) the console line
# ----------------------------------------------------------------------

class FakeTTY:
    """A stdout that says it is a terminal and keeps what is written."""

    def __init__(self):
        self.text = []

    def write(self, s):
        self.text.append(s)
        return len(s)

    def flush(self):
        pass

    def isatty(self):
        return True


def run_loop(pkg, monkeypatch, ticks, steps=None, proc_stat=None,
             num_workers=2, tick=TICK, **cfg_kwargs):
    """One live loop under the fake clock: poll t applies steps[t - 1]
    and proc_stat[t] (busy, total); at poll `ticks` every worker is
    done. Returns (manager, statistics)."""
    manager = FakeManager(pkg, num_workers)
    jiffies = [(0, 0)]
    monkeypatch.setattr(PACKAGES[pkg][4], "_read_proc_stat",
                        staticmethod(lambda: jiffies[0]))

    def on_tick(t):
        if steps is not None and t <= len(steps):
            apply_step(manager, steps[t - 1])
        if proc_stat is not None:
            jiffies[0] = proc_stat[min(t, len(proc_stat) - 1)]
        if t >= ticks:
            manager.shared.num_workers_done = num_workers

    clock = FakeClock(on_tick, tick)
    stats = make_stats(pkg, manager, monkeypatch, clock, **cfg_kwargs)
    stats.live_stats_loop(BenchPhase.READFILES, 0.0)
    return manager, stats


LINE_CASES = {
    "live1n": {"single_line_live_stats_no_erase": True},
    "live1-off-a-terminal": {"use_single_line_live_stats": True},
    "default-off-a-terminal": {},
    "base10": {"single_line_live_stats_no_erase": True,
               "use_base10_units": True},
    "cpu": {"single_line_live_stats_no_erase": True, "show_cpu_util": True},
    "live1-on-a-terminal": {"use_single_line_live_stats": True, "tty": True},
}


@pytest.mark.parametrize("case", sorted(LINE_CASES))
def test_live_lines_equal_the_jax_package(monkeypatch, capsys, case):
    flags = dict(LINE_CASES[case])
    tty = flags.pop("tty", False)
    ticks = 208  # 3.25 s
    steps = counter_steps(11, ticks, 2)
    rng = np.random.default_rng(5)
    busy = np.cumsum(rng.integers(0, 40, size=ticks + 1))
    total = np.cumsum(np.full(ticks + 1, 40))
    proc_stat = [(int(b), int(t)) for b, t in zip(busy, total, strict=True)]
    out = {}
    for pkg in PACKAGES:
        stdout = FakeTTY()
        with monkeypatch.context() as patch:
            if tty:
                patch.setattr(sys, "stdout", stdout)
            run_loop(pkg, patch, ticks, steps, proc_stat,
                     live_stats_interval_ms=250, **flags)
        out[pkg] = "".join(stdout.text) if tty else capsys.readouterr().out
    assert out["port"] == out["jax"]
    if tty:
        assert out["port"].count("\r\x1b[2K") == 14  # 13 lines, the erase
        return
    lines = out["port"].splitlines()
    assert len(lines) == 13  # 3.25 s at --liveint 250
    unit = "MB" if "use_base10_units" in flags else "MiB"
    assert lines[0].startswith(f"READ: 0s; ") and f" {unit}/s; " in lines[0]
    assert lines[-2].endswith("0/2 done" if case != "cpu" else "%")
    assert "; 2/2 done" in lines[-1]  # the poll that saw the phase end
    if case == "cpu":
        assert all("; CPU " in line for line in lines)


def test_rows_fall_on_the_liveint_grid(monkeypatch, capsys, tmp_path):
    """The render cadence, a departure the port chose. At --liveint 250
    with polls 3/64 s apart, the JAX package counts each interval from the
    poll that rendered, so its rows fall 0.28125 s apart: 14 in 4.03 s.
    The port's rows fall on the first poll at or after each multiple of
    0.25 s: 16."""
    rows = {}
    for pkg in PACKAGES:
        csv_path = tmp_path / f"{pkg}.csv"
        run_loop(pkg, monkeypatch, 86, tick=3 / 64,
                 live_stats_interval_ms=250,
                 single_line_live_stats_no_erase=True,
                 live_csv_file_path=str(csv_path))
        printed = capsys.readouterr().out.splitlines()
        rows[pkg] = len(csv_path.read_text().splitlines()) - 1
        assert len(printed) == rows[pkg]
    assert rows == {"jax": 14, "port": 16}


def test_liveint_below_50_ms_renders_at_most_every_50_ms(monkeypatch,
                                                          capsys):
    """--liveint 1 over 1 s of polls 1/64 s apart: a row every fourth
    poll in the JAX package (16), on the 50 ms grid in the port (19 or
    20 with float rounding), not one a poll (64)."""
    got = {}
    for pkg in PACKAGES:
        run_loop(pkg, monkeypatch, 64, live_stats_interval_ms=1,
                 single_line_live_stats_no_erase=True)
        got[pkg] = len(capsys.readouterr().out.splitlines())
    assert got["jax"] == 16 and got["port"] in (19, 20)


def test_nolive_prints_nothing_and_still_writes_the_files(monkeypatch,
                                                         capsys, tmp_path):
    for pkg in PACKAGES:
        csv_path, json_path = tmp_path / f"{pkg}.csv", tmp_path / f"{pkg}.json"
        manager, _ = run_loop(pkg, monkeypatch, 96, disable_live_stats=True,
                              live_stats_interval_ms=250,
                              live_csv_file_path=str(csv_path),
                              live_json_file_path=str(json_path))
        assert capsys.readouterr().out == ""
        assert len(csv_path.read_text().splitlines()) == 1 + 6
        assert len(json_path.read_text().splitlines()) == 6
        assert manager.polls == 96  # the clock and errors checked each poll


# ----------------------------------------------------------------------
# (c) the fullscreen frame
# ----------------------------------------------------------------------

KEYS = (("down", b"\x1b[B"), ("down", b"\x1b[B"), ("down", b"\x1b[B"),
        ("pgdn", b"\x1b[6~"), ("end", b"\x1b[F"), ("home", b"\x1b[H"),
        ("j, j, k", b"jjk"), ("G", b"G"), ("pgup", b"\x1b[5~"),
        ("g", b"g"))


def fullscreen_frames(pkg, monkeypatch, capsys):
    """Frames of 16 workers on a 12-line terminal: the first, then one
    after each key of KEYS (fed through a pipe as stdin)."""
    manager = FakeManager(pkg, 16)
    steps = counter_steps(3, 1, 16)
    apply_step(manager, steps[0])
    rng = np.random.default_rng(9)
    for i, w in enumerate(manager.workers):
        w.phase_finished = i % 5 == 0
        lat = rng.integers(1, 50_000, size=40)
        for v in lat:
            w.iops_latency_histo.add_latency(float(v))
    monkeypatch.setattr(shutil, "get_terminal_size",
                        lambda fallback=None: os.terminal_size((100, 12)))
    stats = make_stats(pkg, manager, monkeypatch, FakeClock(),
                       show_cpu_util=False)
    frames, scrolls = [], []

    def render():
        stats._render_fullscreen(BenchPhase.READFILES, 3, 1234.5, 678.9,
                                 "MiB", 1 << 20, 3)
        frames.append(capsys.readouterr().out)
        scrolls.append(stats._fs_scroll)

    render()
    read_fd, write_fd = os.pipe()
    stdin = os.fdopen(read_fd, "rb", buffering=0)
    monkeypatch.setattr(sys, "stdin", stdin)
    stats._fs_old_termios = (read_fd, None)  # keys on, as on a terminal
    try:
        for _name, key in KEYS:
            os.write(write_fd, key)
            render()
    finally:
        stats._fs_old_termios = None
        monkeypatch.setattr(sys, "stdin", sys.__stdin__)
        stdin.close()
        os.close(write_fd)
    return frames, scrolls


def test_fullscreen_frames_and_keys_equal_the_jax_package(monkeypatch,
                                                          capsys):
    got = {pkg: fullscreen_frames(pkg, monkeypatch, capsys)
           for pkg in PACKAGES}
    assert got["port"] == got["jax"]
    frames, scrolls = got["port"]
    # 6 rows fit; the window moves by keys and stays in 0..10
    assert scrolls == [0, 1, 2, 3, 9, 10, 0, 1, 10, 4, 0]
    assert frames[0].startswith("\x1b[2J\x1b[H\x1b[2K")
    assert "Phase: READ   Elapsed: 3s   Done: 3/16" in frames[0]
    assert "... showing 0..5 of 16 workers" in frames[0]
    assert "... showing 10..15 of 16 workers" in frames[5]
    assert "IO lat us: p50=" in frames[0] and "max=" in frames[0]
    assert "    done" in frames[0] and "     run" in frames[0]


def test_fullscreen_entry_latency_footer_and_cpu(monkeypatch, capsys):
    """A phase without IO latencies shows its entry latencies; --cpu adds
    the CPU column to the header line."""
    out = {}
    for pkg in PACKAGES:
        manager = FakeManager(pkg, 2)
        for w in manager.workers:
            w.entries_latency_histo.add_latency(100.0)
        monkeypatch.setattr(PACKAGES[pkg][4], "_read_proc_stat",
                            staticmethod(lambda: (30, 120)))
        stats = make_stats(pkg, manager, monkeypatch, FakeClock(),
                           show_cpu_util=True)
        stats._render_fullscreen(BenchPhase.CREATEDIRS, 1, 0.0, 10.0,
                                 "MiB", 1 << 20, 0)
        out[pkg] = capsys.readouterr().out
        stats.close()
    assert out["port"] == out["jax"]
    assert "  CPU: 25%" in out["port"]
    assert "Entry lat us: p50=" in out["port"]


# ----------------------------------------------------------------------
# (d) under a real pty
# ----------------------------------------------------------------------

def _set_winsize(fd, rows, cols):
    fcntl.ioctl(fd, termios.TIOCSWINSZ, struct.pack("HHHH", rows, cols, 0, 0))


def _drain(fd, out, secs):
    end = time.monotonic() + secs
    while time.monotonic() < end:
        if select.select([fd], [], [], 0.05)[0]:
            try:
                chunk = os.read(fd, 4096)
            except OSError:
                return
            if not chunk:
                return
            out += chunk


def test_fullscreen_under_a_pty_scrolls_and_restores_the_terminal(
        tmp_path):
    """The port's CLI on a 12-line pty with 16 workers: per-worker rows,
    the scroll footer, an arrow key that moves the window; the child
    exits 0 with the terminal back in canonical mode and the result table
    printed."""
    master, slave = pty.openpty()
    _set_winsize(slave, 12, 100)
    before = termios.tcgetattr(slave)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["ELBENCHO_TPU_NO_DEFAULT_RESFILES"] = "1"
    env.pop("LINES", None)
    env.pop("COLUMNS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", PORT_CHILD, "-w", "-t", "16", "-s", "16M",
         "-b", "16K", "--infloop", "--timelimit", "4", "--liveint", "150",
         str(tmp_path / "f.bin")],
        stdin=slave, stdout=slave, stderr=subprocess.DEVNULL, env=env,
        cwd=REPO)
    out = bytearray()
    try:
        deadline = time.monotonic() + 60
        while b"Rank" not in out and time.monotonic() < deadline:
            _drain(master, out, 0.2)
        _drain(master, out, 0.5)
        for _ in range(4):
            os.write(master, b"\x1b[B")  # arrow down
            _drain(master, out, 0.2)
        while proc.poll() is None and time.monotonic() < deadline:
            _drain(master, out, 0.3)
        _drain(master, out, 1.0)
        rc = proc.wait(timeout=30)
        after = termios.tcgetattr(slave)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        os.close(master)
        os.close(slave)
    assert rc == 0
    text = out.decode(errors="replace")
    assert "\x1b[2J" in text and "Rank" in text and " run" in text
    assert "of 16 workers" in text and "showing 0.." in text
    assert any(f"showing {n}.." in text for n in range(1, 11)), \
        "the arrow key did not move the worker window"
    assert "IO lat us: p50=" in text
    assert after[3] == before[3]  # lflag: ICANON and ECHO are back
    assert after[3] & termios.ICANON
    assert "WRITE" in text and "Throughput" in text


# ----------------------------------------------------------------------
# (e) the live CPU meter
# ----------------------------------------------------------------------

def phase_cpu(pkg, monkeypatch, capsys, tmp_path, live):
    """A phase of two workers under the fake clock (64 polls a second,
    40 jiffies a poll) with a /proc/stat that is busy for 1 s, idle for
    1 s to the first done, busy for 1 s to the last; live --cpu renders
    every 250 ms, or --nolive. Returns the (first done, last done) CPU
    use of the real WorkerManager and its shared data."""
    from elbencho_tpu.workers.manager import WorkerManager as JaxManager
    from elbencho_tpu_torch.workers.manager import WorkerManager
    stats_mod, args_mod, _ops, _histo, cpu_cls = PACKAGES[pkg]
    jiffies = [(0, 0)]
    monkeypatch.setattr(cpu_cls, "_read_proc_stat",
                        staticmethod(lambda: jiffies[0]))
    cfg = args_mod.BenchConfig(
        run_read_files=True, file_size=4096, paths=[str(tmp_path / "f")],
        show_cpu_util=True, disable_live_stats=not live,
        single_line_live_stats_no_erase=True, live_stats_interval_ms=250)
    manager = (JaxManager if pkg == "jax" else WorkerManager)(cfg)
    manager.workers = [fake_worker(pkg, r) for r in range(2)]
    manager.shared.start_phase(BenchPhase.READFILES)

    def on_tick(t):
        busy = min(t, 64) + max(t - 128, 0)
        jiffies[0] = (40 * busy, 40 * t)
        if t in (128, 192):
            manager.shared.inc_num_workers_done()

    monkeypatch.setattr(stats_mod, "time", FakeClock(on_tick))
    stats_mod.Statistics(cfg, manager).live_stats_loop(
        BenchPhase.READFILES, time.monotonic())
    manager.wait_for_workers_done(time.monotonic())
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == (12 if live else 0)
    assert all(line.endswith("%") for line in lines)
    return manager.shared.cpu_util_stonewall, manager.shared.cpu_util_last_done


def test_live_cpu_renders_leave_the_phase_cpu_as_it_is(monkeypatch, capsys,
                                                       tmp_path):
    got = {(pkg, live): phase_cpu(pkg, monkeypatch, capsys, tmp_path, live)
           for pkg in PACKAGES for live in (False, True)}
    # busy 64 of 128 polls to the first done, 128 of 192 to the last
    assert got["port", True] == got["port", False] == \
        (50.0, pytest.approx(200 / 3))
    # the JAX package: one meter, read at the first done since the last
    # done without live renders (100 %, a fault the port does not keep);
    # with them, since the last render: idle before the first done, and
    # no time at all at the last
    assert got["jax", False] == (50.0, 100.0)
    assert got["jax", True] == (0.0, 0.0)


# ----------------------------------------------------------------------
# (f) run control with live statistics on
# ----------------------------------------------------------------------

LIVE_ON = ["--liveint", "100", "--live1n"]


def test_timelimit_holds_with_live_on(tmp_path, capsys):
    path = tmp_path / "f.bin"
    path.write_bytes(bytes(4 << 20))
    jf = tmp_path / "run.json"
    assert port_main(["-r", "-t", "2", "-b", "1M", "--gpuids", "0",
                      "--infloop", "--timelimit", "1", *LIVE_ON, "--cpu",
                      "--jsonfile", str(jf), str(path)], device="cpu") == 0
    (rec,) = records(jf)
    assert 0 <= rec["ElapsedUSecLast"] / 1e6 - 1 <= SLACK_S
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("READ: ")]
    assert 8 <= len(lines) <= 10 + int(SLACK_S * 10)
    assert all(line.endswith("%") for line in lines)


def corrupt_file(path, size=4 << 20):
    assert run_port(["-w", "-t", "1", "-s", str(size), "-b", "1M",
                     "--verify", "7"], [path]) == 0
    data = bytearray(path.read_bytes())
    data[100] ^= 0x01  # in the first worker's first block
    path.write_bytes(bytes(data))


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_a_worker_error_interrupts_the_survivors_with_live_on(tmp_path,
                                                              capsys, pkg):
    """-t 2 --infloop: worker 0 fails its verify read at once; the live
    loop interrupts worker 1, which would loop until the limit."""
    path = tmp_path / "f.bin"
    corrupt_file(path)
    args = ["-r", "-t", "2", "-b", "1M", "--verify", "7", "--gpuids", "0",
            "--infloop", "--timelimit", "60", *LIVE_ON, str(path)]
    t0 = time.monotonic()
    rc = jax_main(jax_args(args)) if pkg == "jax" \
        else port_main(args, device="cpu")
    assert rc == 1
    assert time.monotonic() - t0 < 30
    assert "Aborting due to worker error" in capsys.readouterr().err


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_an_aborted_run_removes_header_only_live_files(tmp_path, capsys,
                                                       pkg):
    """A worker error before the first render: the run wrote no live row,
    so the live files it would have appended to go when they hold no
    more than a header; a file with rows of an earlier run stays."""
    path = tmp_path / "f.bin"
    corrupt_file(path)
    csv_path, json_path = tmp_path / "live.csv", tmp_path / "live.json"
    csv_path.write_text(CSV_HEADER + "\n")
    json_path.write_text("")
    kept = tmp_path / "kept.json"
    kept.write_text('{"Phase": "READ"}\n')
    for live_json in (json_path, kept):
        args = ["-r", "-t", "1", "-b", "1M", "--verify", "7", "--gpuids",
                "0", "--liveint", "60000", "--livecsv", str(csv_path),
                "--livejson", str(live_json), str(path)]
        rc = jax_main(jax_args(args)) if pkg == "jax" \
            else port_main(args, device="cpu")
        assert rc == 1
    assert not csv_path.exists() and not json_path.exists()
    assert kept.read_text() == '{"Phase": "READ"}\n'


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_an_interrupted_run_keeps_live_files_with_rows(tmp_path, pkg):
    path = tmp_path / "f.bin"
    path.write_bytes(bytes(1 << 20))
    csv_path, json_path = tmp_path / "live.csv", tmp_path / "live.json"
    child = spawn(pkg, ["-r", "-t", "2", "-b", "64K", "--gpuids", "0",
                        "--infloop", "--nolive", "--liveint", "100",
                        "--livecsv", str(csv_path), "--livejson",
                        str(json_path), str(path)])
    try:
        wait_for(lambda: csv_path.exists()
                 and len(csv_path.read_text().splitlines()) >= 3)
        child.send_signal(signal.SIGINT)
        _out, err = child.communicate(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert child.returncode == 3, err
    csv_lines = csv_path.read_text().splitlines()
    json_rows = [json.loads(line) for line in
                 json_path.read_text().splitlines()]
    assert csv_lines[0] == CSV_HEADER and len(csv_lines) >= 3
    assert len(json_rows) == len(csv_lines) - 1
    assert {r["Phase"] for r in json_rows} == {"READ"}


# ----------------------------------------------------------------------
# (g) end to end
# ----------------------------------------------------------------------

def test_end_to_end_live_files_hold_the_invariants(tmp_path):
    """-w -r --infloop --timelimit 2 in both packages: each package's live
    rows name the phases in order, never go back in Seconds or Bytes
    within a phase, and end at most at the phase's BytesLast."""
    flags = ["-w", "-r", "-t", "2", "-s", "4M", "-b", "1M", "--infloop",
             "--timelimit", "2", "--liveint", "100"]
    for pkg, run in (("jax", run_jax), ("port", run_port)):
        csv_path = tmp_path / f"{pkg}.live.csv"
        json_path = tmp_path / f"{pkg}.live.json"
        jf = tmp_path / f"{pkg}.json"
        assert run(flags + ["--livecsv", str(csv_path), "--livejson",
                            str(json_path)], [tmp_path / f"{pkg}.bin"],
                   jf) == 0
        recs = records(jf)
        assert [r["Phase"] for r in recs] == ["WRITE", "READ"]
        csv_lines = csv_path.read_text().splitlines()
        rows = [json.loads(line) for line in
                json_path.read_text().splitlines()]
        assert csv_lines[0] == CSV_HEADER
        assert [line.split(",")[2:] for line in csv_lines[1:]] == \
            [[r["Phase"], str(r["Seconds"]), str(r["Entries"]),
              str(r["Bytes"]), str(r["IOPS"])] for r in rows]
        phases = [r["Phase"] for r in rows]
        assert phases == sorted(phases, key=["WRITE", "READ"].index)
        for rec in recs:
            mine = [r for r in rows if r["Phase"] == rec["Phase"]]
            assert len(mine) >= 10, (pkg, rec["Phase"], len(mine))
            for key in ("Seconds", "Bytes"):
                assert [r[key] for r in mine] == sorted(r[key] for r in mine)
            assert mine[-1]["Bytes"] <= rec["BytesLast"]
            assert mine[-1]["Seconds"] <= 2
