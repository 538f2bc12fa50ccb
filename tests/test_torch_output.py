"""A phase's result output of the port's CLI (device="cpu") against the
JAX package's: the latency rows (--lat, --lathisto, --latpercent,
--latpercent9s, --allelapsed), --cpu, --base10, the 0 us warning and the
result files (--resfile, --csvfile, --nocsvlabels, the default files).

Times are never compared, only their shape: the ordered row labels (the
port's device rows renamed, see PORT_ROW_NAMES), the percentile keys,
the number of worker elapsed times. Counts are compared at tolerance 0:
an uncut phase's IO latency histogram holds one value per op in every
loop of both packages (the Python loop, the fused ring, the engine's
block loop, --gpubench, --gpuslice).
"""

import contextlib
import datetime
import getpass
import io
import os
import re
import signal
import subprocess
import sys
import time

import pytest
import torch

import elbencho_tpu.config.args as jax_args_mod
import elbencho_tpu_torch.config.args as port_args_mod
from elbencho_tpu.cli import main as jax_main
from elbencho_tpu.stats import statistics as jax_stats
from elbencho_tpu_torch.cli import main as port_main
from elbencho_tpu_torch.stats import statistics as port_stats
from elbencho_tpu_torch.stats.latency_histogram import LatencyHistogram
from test_torch_dirmode import jax_args, records
from test_torch_e2e import _jax_python_loop  # noqa: F401
from test_torch_runcontrol import read_until, sparse_file, spawn

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICE_IDS = ",".join(str(i) for i in range(8))

#: the JAX package's device row labels -> the port's
PORT_ROW_NAMES = ((r"^HBM ingest (\S+)$", r"Device \1"),
                  (r"^chip (\d+) ", r"gpu \1 "),
                  (r"^HBM DMA us/op$", "Dev copy us/op"),
                  (r"^HBM dispatch us/op$", "Dev dispatch us/op"))

OUTPUT_FLAGS = ["--lat", "--lathisto", "--latpercent", "--allelapsed",
                "--cpu", "--nolive"]


def row_labels(lines, renamed=False):
    """[(operation, result type)] of a result table's rows."""
    out = []
    for line in lines:
        label = line[12:].split(":")[0].strip()
        if renamed:
            for pat, repl in PORT_ROW_NAMES:
                label = re.sub(pat, repl, label)
        out.append((line[:12].strip(), label))
    return out


def table_lines(text):
    """The result table of a console output: the header, the rule and the
    rows of every phase (log lines start with a date)."""
    lines = text.splitlines()
    start = next(i for i, line in enumerate(lines)
                 if line.startswith("OPERATION"))
    return [line for line in lines[start:]
            if not re.match(r"\d{4}-\d\d-\d\d ", line)]


def pcts(lines):
    """{percentile key: value} of each 'IO lat pcts' row."""
    return [dict(kv.split("=") for kv in line.split(":", 1)[1].split())
            for line in lines if "IO lat pcts :" in line]


def run_pair(tmp_path, flags, paths, jax_extra, port_extra, name="run"):
    """`flags` (port names) through both CLIs with all three result
    files; returns {pkg: (result file lines, CSV lines, records)}."""
    out = {}
    for pkg in ("jax", "port"):
        files = {ext: tmp_path / f"{name}.{pkg}.{ext}"
                 for ext in ("txt", "csv", "json")}
        argv = flags + ["--resfile", str(files["txt"]), "--csvfile",
                        str(files["csv"]), "--jsonfile",
                        str(files["json"])]
        pkg_paths = [str(tmp_path / f"{pkg}.{p}") for p in paths]
        if pkg == "jax":
            rc = jax_main(jax_args(argv) + jax_extra + pkg_paths)
        else:
            rc = port_main(argv + port_extra + pkg_paths, device="cpu")
        assert rc == 0, pkg
        out[pkg] = (files["txt"].read_text().splitlines(),
                    files["csv"].read_text().splitlines(),
                    records(files["json"]))
    return out


# ----------------------------------------------------------------------
# the rows, against the JAX package
# ----------------------------------------------------------------------

FILE_FLAGS = ["-w", "-r", "-t", "2", "-s", "2M", "-b", "256K",
              "--iodepth", "2"]
ROW_CASES = {
    # name: (flags, bench paths, JAX flags, port flags)
    "file-fused-ring": (FILE_FLAGS, ["f.bin"],
                        ["--tpuids", "0", "--tpustream", "off"],
                        ["--gpuids", "0"]),
    "file-python-loop": (FILE_FLAGS, ["f.bin"],
                         ["--tpuids", "0", "--tpustream", "off"],
                         ["--gpuids", "0", "--gpustream", "off"]),
    "file-host-block-loop": (FILE_FLAGS, ["f.bin"], [], []),
    "dir": (["-d", "-w", "-r", "-t", "2", "-n", "1", "-N", "4", "-s",
             "64K", "-b", "16K"], ["d"],
            ["--tpuids", "0", "--tpustream", "off"], ["--gpuids", "0"]),
    "gpubench-h2d": (["--gpubench", "--gpubenchpat", "h2d", "-t", "2",
                      "-s", "512K", "-b", "64K", "--iodepth", "2"], [],
                     [], []),
    "slice": (["-w", "--gpuslice", "-t", "2", "-s", "1M", "-b", "64K"],
              ["s.bin"], ["--tpuids", SLICE_IDS],
              ["--gpuids", SLICE_IDS]),
}
NINES_CASES = {"9s2": ["--latpercent9s", "2"],
               "9s3-base10": ["--latpercent9s", "3", "--base10"]}


@pytest.mark.parametrize("nines", sorted(NINES_CASES))
@pytest.mark.parametrize("case", sorted(ROW_CASES))
def test_rows_equal_the_jax_package(tmp_path, capsys, case, nines):
    flags, paths, jax_extra, port_extra = ROW_CASES[case]
    if case == "dir":
        for pkg in ("jax", "port"):
            (tmp_path / f"{pkg}.d").mkdir()
    extra = NINES_CASES[nines]
    out = run_pair(tmp_path, flags + OUTPUT_FLAGS + extra, paths,
                   jax_extra, port_extra)
    capsys.readouterr()
    (jax_res, _, jax_recs), (port_res, _, port_recs) = \
        out["jax"], out["port"]
    assert row_labels(port_res) == row_labels(jax_res, renamed=True)
    assert port_res[0] == jax_res[0]  # the header line
    # --base10 reaches every rate row, the device rows too
    unit = "MB" if "--base10" in extra else "MiB"
    port_labels = [label for _, label in row_labels(port_res[1:])]
    assert not any(("MiB" if unit == "MB" else " MB") in label
                   for label in port_labels)
    if port_extra[:1] == ["--gpuids"] and case != "slice":
        assert f"Device {unit}/s" in port_labels
        assert f"gpu 0 {unit}/s" in port_labels
    # the same percentile keys, each the JSON histogram's percentile
    port_pcts, jax_pcts = pcts(port_res), pcts(jax_res)
    assert [list(p) for p in port_pcts] == [list(p) for p in jax_pcts]
    assert list(port_pcts[0])[-1] == \
        ("p99.9" if "3" in extra else "p99")
    nines_n = int(extra[1])
    for rows, recs in ((port_res, port_recs), (jax_res, jax_recs)):
        io_recs = [r for r in recs if r["IOLatHisto"]["LatNumValues"]]
        assert len(pcts(rows)) == len(io_recs)
        for row_pcts, rec in zip(pcts(rows), io_recs, strict=True):
            histo = LatencyHistogram.from_dict(rec["IOLatHisto"])
            want = {k: f"{v:.0f}" for k, v in
                    histo.percentiles_nines(nines_n).items()}
            assert row_pcts == want
            values = [float(v) for v in row_pcts.values()]
            assert values == sorted(values)
            assert rec["IOLatUSecMin"] <= rec["IOLatUSecAvg"] \
                <= rec["IOLatUSecMax"]
    # one elapsed time per worker
    for rows, recs in ((port_res, port_recs), (jax_res, jax_recs)):
        elapsed = [line.split(":", 1)[1].split(",") for line in rows
                   if "Worker elapsed" in line]
        assert [len(e) for e in elapsed] == \
            [len(r["ElapsedUSecList"]) for r in recs]
    # an uncut phase books one IO latency per op, one entry latency per
    # entry of the phases that time entries, in both packages
    assert [r["Phase"] for r in port_recs] == [r["Phase"] for r in jax_recs]
    block = int(flags[flags.index("-b") + 1][:-1]) << 10
    for jr, pr in zip(jax_recs, port_recs, strict=True):
        for rec in (jr, pr):
            ops = rec["BytesLast"] // block
            assert rec["IOLatHisto"]["LatNumValues"] == ops, rec["Phase"]
        assert pr["EntLatHisto"]["LatNumValues"] == \
            jr["EntLatHisto"]["LatNumValues"], pr["Phase"]
    if case == "slice":
        (sl,) = [r for r in port_recs if r["Phase"] == "TPUSLICE"]
        assert sl["EntLatHisto"]["LatNumValues"] == sl["EntriesLast"] > 0


def test_the_result_file_holds_the_header_and_every_row(tmp_path, capsys):
    """In both packages: the printed table without its rule line."""
    texts = {}
    for pkg, main, extra in (
            ("jax", jax_main, ["--tpuids", "0", "--tpustream", "off"]),
            ("port", lambda a: port_main(a, device="cpu"),
             ["--gpuids", "0"])):
        res = tmp_path / f"{pkg}.txt"
        argv = FILE_FLAGS + OUTPUT_FLAGS + ["-i", "2", "--resfile",
                                            str(res)]
        argv = (jax_args(argv) if pkg == "jax" else argv) + extra
        assert main(argv + [str(tmp_path / f"{pkg}.bin")]) == 0
        printed = table_lines(capsys.readouterr().out)
        rule = [line for line in printed if line.startswith("=====")]
        assert len(rule) == 2  # one table per iteration
        texts[pkg] = res.read_text().splitlines()
        assert texts[pkg] == [line for line in printed
                              if not line.startswith("=====")]
    assert row_labels(texts["port"]) == row_labels(texts["jax"],
                                                   renamed=True)


# ----------------------------------------------------------------------
# the CSV
# ----------------------------------------------------------------------

def csv_rows(lines):
    header = lines[0].split(",")
    return header, [dict(zip(header, line.split(","), strict=True))
                    for line in lines[1:]]


def test_csv_fixed_columns_equal_the_jax_package_and_the_records(
        tmp_path, capsys):
    out = run_pair(tmp_path, FILE_FLAGS + OUTPUT_FLAGS
                   + ["-i", "2", "--label", "a,b"], ["f.bin"],
                   ["--tpuids", "0", "--tpustream", "off"],
                   ["--gpuids", "0"])
    capsys.readouterr()
    fixed = jax_stats.Statistics.CSV_RESULT_COLUMNS
    assert len(fixed) == 36
    assert port_stats.CSV_RESULT_COLUMNS == fixed
    for pkg in ("jax", "port"):
        _res, csv, recs = out[pkg]
        header, rows = csv_rows(csv)
        assert tuple(header[:36]) == fixed
        assert csv.count(csv[0]) == 1  # -i 2: the header only once
        assert len(rows) == len(recs) == 4
        for row, rec in zip(rows, recs, strict=True):
            assert row["Label"] == "a;b" and rec["Label"] == "a,b"
            for col in fixed:
                if col in rec:
                    assert row[col] == str(rec[col]).replace(",", ";"), col
    # the port's columns of features it lacks hold what the JAX package
    # writes with them off
    _, port_rows = csv_rows(out["port"][1])
    _, jax_rows = csv_rows(out["jax"][1])
    for pr, jr in zip(port_rows, jax_rows, strict=True):
        for col in port_stats.CSV_FEATURE_OFF_COLUMNS:
            assert col not in out["port"][2][0]
            assert pr[col] == jr[col], col
    # the labels after the fixed columns are each package's config
    assert csv_rows(out["port"][1])[0][36:] == \
        list(port_args_mod.BenchConfig().config_labels())


def test_csv_compat_check(tmp_path):
    """As the JAX package's test_e2e_local.py::test_csv_compat_check:
    appending needs a matching column count, checked before any phase
    runs."""
    target = tmp_path / "f"
    csv = tmp_path / "out.csv"
    args = ["-w", "-t", "1", "-s", "4K", "-b", "4K", "--nolive",
            "--csvfile", str(csv), str(target)]
    assert port_main(args, device="cpu") == 0
    assert port_main(args, device="cpu") == 0  # same schema: append works
    assert len(csv.read_text().splitlines()) == 3  # header + 2 rows
    bad = tmp_path / "bad.csv"
    bad.write_text("a,b,c\n1,2,3\n")
    rc = port_main(["-w", "-t", "1", "-s", "4K", "-b", "4K", "--nolive",
                    "--csvfile", str(bad), str(target)], device="cpu")
    assert rc == 1
    assert bad.read_text() == "a,b,c\n1,2,3\n"  # untouched
    # --nocsvlabels changes the schema -> also rejected against labeled file
    before = csv.read_text()
    rc2 = port_main(["-w", "-t", "1", "-s", "4K", "-b", "4K", "--nolive",
                     "--nocsvlabels", "--csvfile", str(csv), str(target)],
                    device="cpu")
    assert rc2 == 1
    assert csv.read_text() == before
    # and a --nocsvlabels file holds the fixed columns alone
    bare = tmp_path / "bare.csv"
    assert port_main(["-w", "-t", "1", "-s", "4K", "-b", "4K", "--nolive",
                      "--nocsvlabels", "--csvfile", str(bare),
                      str(target)], device="cpu") == 0
    assert tuple(bare.read_text().splitlines()[0].split(",")) == \
        port_stats.CSV_RESULT_COLUMNS


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_csv_of_the_other_package_is_refused(tmp_path, capsys, writer):
    csv = tmp_path / "out.csv"
    args = ["-w", "-s", "64K", "-b", "16K", "--nolive", "--csvfile",
            str(csv)]
    first, second = (jax_main, lambda a: port_main(a, device="cpu"))
    if writer == "port":
        first, second = second, first
    assert first(args + [str(tmp_path / "a.bin")]) == 0
    before = csv.read_text()
    capsys.readouterr()
    assert second(args + [str(tmp_path / "b.bin")]) == 1
    assert "column compatibility check failed" in capsys.readouterr().err
    assert csv.read_text() == before
    assert not (tmp_path / "b.bin").exists()  # no phase ran


def test_dryrun_runs_the_csv_check_in_both_packages(tmp_path, capsys):
    bad = tmp_path / "bad.csv"
    bad.write_text("a,b\n1,2\n")
    args = ["-w", "-s", "64K", "--dryrun", "--csvfile", str(bad),
            str(tmp_path / "f.bin")]
    assert jax_main(args) == 1
    assert port_main(args, device="cpu") == 1
    errs = capsys.readouterr().err.splitlines()
    assert len(errs) == 2 and all(e.startswith("ERROR: CSV output file")
                                  for e in errs)
    assert bad.read_text() == "a,b\n1,2\n"


def test_chart_tool_renders_the_ports_csv(tmp_path, capsys):
    bench = tmp_path / "bench"
    bench.mkdir()
    csvfile = tmp_path / "res.csv"
    assert port_main(["-w", "-d", "-r", "-t", "1", "-n", "1", "-N", "2",
                      "-s", "8K", "-b", "8K", "--csvfile", str(csvfile),
                      "--nolive", str(bench)], device="cpu") == 0
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "elbencho-tpu-chart"),
         str(csvfile)], capture_output=True, text=True, env=env,
        timeout=180)
    assert res.returncode == 0, res.stderr
    assert "#" in res.stdout  # bars rendered
    assert "WRITE" in res.stdout and "READ" in res.stdout


# ----------------------------------------------------------------------
# the default result files
# ----------------------------------------------------------------------

@pytest.fixture
def default_files(tmp_path, monkeypatch):
    """Both packages' default result directory under tmp_path, the
    opt-out unset for this test only; returns the base of the names."""
    monkeypatch.delenv("ELBENCHO_TPU_NO_DEFAULT_RESFILES", raising=False)
    base = tmp_path / "var_tmp"
    base.mkdir()
    for mod in (jax_args_mod, port_args_mod):
        monkeypatch.setattr(mod.BenchConfig, "_default_results_base",
                            staticmethod(lambda: str(base)))
    date = datetime.date.today().strftime("%Y%m%d")
    return (base / f"elbencho-tpu_results_{getpass.getuser()}"
            / f"elbencho-tpu_results_{date}")


def test_default_result_files_are_written(tmp_path, capsys, default_files):
    assert port_main(["-w", "-r", "-s", "64K", "-b", "16K", "--nolive",
                      str(tmp_path / "f.bin")], device="cpu") == 0
    capsys.readouterr()
    txt, csv, js = (default_files.with_suffix(ext)
                    for ext in (".txt", ".csv", ".json"))
    assert txt.read_text().startswith("OPERATION")
    assert len(csv.read_text().splitlines()) == 3
    assert [r["Phase"] for r in records(js)] == ["WRITE", "READ"]
    assert oct(default_files.parent.stat().st_mode & 0o777) == "0o700"
    # an explicit file is not replaced by a default one
    mine = tmp_path / "mine.csv"
    assert port_main(["-r", "--nolive", "--csvfile", str(mine),
                      str(tmp_path / "f.bin")], device="cpu") == 0
    assert len(mine.read_text().splitlines()) == 2
    assert len(csv.read_text().splitlines()) == 3
    assert len(records(js)) == 3


@pytest.mark.parametrize("first", ["jax", "port"])
def test_a_defaulted_csv_of_the_other_width_rotates(tmp_path, capsys,
                                                     default_files, first):
    runs = {"jax": jax_main,
            "port": lambda a: port_main(a, device="cpu")}
    second = "port" if first == "jax" else "jax"
    args = ["-w", "-s", "64K", "-b", "16K", "--nolive"]
    assert runs[first](args + [str(tmp_path / "a.bin")]) == 0
    csv = default_files.with_suffix(".csv")
    before = csv.read_text()
    capsys.readouterr()
    assert runs[second](args + [str(tmp_path / "b.bin")]) == 0
    out = capsys.readouterr().out
    rotated = csv.with_name(csv.stem + "_2.csv")
    assert f"writing to {rotated} instead" in out
    assert csv.read_text() == before
    header, rows = csv_rows(rotated.read_text().splitlines())
    assert len(rows) == 1 and rows[0]["Phase"] == "WRITE"
    # both packages' records land in the one default JSON file
    assert len(records(default_files.with_suffix(".json"))) == 2


# ----------------------------------------------------------------------
# the 0 us warning, the dispatch rows' guard, the CPU meters
# ----------------------------------------------------------------------

def test_0usec_warning(tmp_path, capsys):
    """As the JAX package's test_parity_extras.py::test_0usec_warning: the
    warning appears exactly when the fastest worker's elapsed is 0 us,
    with the JAX package's text, and --no0usecerr silences it."""
    from elbencho_tpu_torch.phases import BenchPhase
    from elbencho_tpu_torch.workers.local_worker import LocalWorker
    from elbencho_tpu_torch.workers.manager import WorkerManager

    def render(extra_args):
        cfg = port_args_mod.BenchConfig(
            run_create_files=True, file_size=4096,
            paths=[str(tmp_path / "f")], **extra_args)
        cfg.derive()
        manager = WorkerManager(cfg)
        worker = LocalWorker(manager.shared, 0)
        worker.got_phase_work = True
        worker.stonewall_taken = True
        worker.stonewall_elapsed_usec = 0
        worker.elapsed_usec_vec = [0]
        worker.live_ops.num_entries_done = 1
        manager.workers = [worker]
        port_stats.Statistics(cfg, manager).print_phase_results(
            BenchPhase.CREATEFILES)
        return capsys.readouterr().out

    warning = [line for line in render({}).splitlines()
               if "WARNING" in line]
    assert warning == [
        f"{'':12}WARNING: phase completed in 0 microseconds; results may "
        f"be bogus (too little work?). --no0usecerr silences this."]
    assert "WARNING" not in render({"ignore_0usec_errors": True})


def _device_rows(pkg, tmp_path, dispatch_usec, copy_usec):
    """Device rows of a synthetic phase with one staged copy."""
    mod = jax_stats if pkg == "jax" else port_stats
    args = jax_args_mod if pkg == "jax" else port_args_mod
    cfg = args.BenchConfig(run_create_files=True, file_size=4096,
                           paths=[str(tmp_path / "f")])
    res = mod.PhaseResults()
    res.phase_name = "WRITE"
    res.stonewall = {"entries": 0, "bytes": 0, "iops": 0}
    res.final = dict(res.stonewall)
    if pkg == "jax":
        res.stonewall_rwmix = dict(res.stonewall)
        res.final_rwmix = dict(res.stonewall)
    res.last_done_usec = 1000
    res.tpu_bytes = 4096
    res.tpu_per_chip = {0: (4096, copy_usec)}
    res.tpu_path_counters = {"TpuH2dStagedOps": 1}
    res.tpu_dispatch_usec, res.tpu_usec = dispatch_usec, copy_usec
    stats = mod.Statistics.__new__(mod.Statistics)  # no manager needed
    stats.cfg = cfg
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        stats._render_result_rows(res)
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("usec", [(0, 0), (3, 40)])
def test_dispatch_rows_guard_equals_the_jax_package(tmp_path, capsys, usec):
    """The per-op dispatch and copy rows show only when the phase timed a
    copy: a phase whose copies took no measured time prints neither."""
    jax_rows = _device_rows("jax", tmp_path, *usec)
    port_rows = _device_rows("port", tmp_path, *usec)
    capsys.readouterr()
    assert row_labels(port_rows[1:]) == row_labels(jax_rows[1:],
                                                   renamed=True)
    assert any("Dev copy us/op" in line for line in port_rows) == \
        (usec != (0, 0))


def test_the_last_done_cpu_util_covers_the_whole_phase(tmp_path,
                                                       monkeypatch):
    """Two meters, both baselined at the phase start (upstream's
    cpuUtilFirstDone/cpuUtilLastDone): the host was busy half the time up
    to the first done and idle after it, so the whole phase was 25 %
    busy. The JAX package reads its one meter again at the last done and
    so covers only the idle tail."""
    from elbencho_tpu.workers.manager import WorkerManager as JaxManager
    from elbencho_tpu_torch.phases import BenchPhase
    from elbencho_tpu_torch.stats.cpu_util import CPUUtil
    from elbencho_tpu_torch.workers.manager import WorkerManager
    from elbencho_tpu.stats import cpu_util as jax_cpu_util
    proc_stat = [(0, 0)]
    for cls in (CPUUtil, jax_cpu_util.CPUUtil):
        monkeypatch.setattr(cls, "_read_proc_stat",
                            staticmethod(lambda: proc_stat[0]))
    got = {}
    for pkg, manager_cls, args in (
            ("port", WorkerManager, port_args_mod),
            ("jax", JaxManager, jax_args_mod)):
        cfg = args.BenchConfig(run_read_files=True, file_size=4096,
                               paths=[str(tmp_path / "f")])
        manager = manager_cls(cfg)
        manager.workers = []
        proc_stat[0] = (0, 0)
        manager.shared.start_phase(BenchPhase.READFILES)
        proc_stat[0] = (50, 100)
        manager.shared.inc_num_workers_done()
        proc_stat[0] = (50, 200)
        manager.wait_for_workers_done(time.monotonic())
        got[pkg] = (manager.shared.cpu_util_stonewall,
                    manager.shared.cpu_util_last_done)
    assert got == {"port": (50.0, 25.0), "jax": (50.0, 0.0)}


def test_the_cpu_meter_reads_proc_stat_as_the_jax_package(monkeypatch):
    """Both packages' meters give the busy share of the /proc/stat
    jiffies since the last update, and 0 % where /proc/stat does not
    advance (some container runtimes report every counter as 0)."""
    from elbencho_tpu.stats.cpu_util import CPUUtil as JaxCPUUtil
    from elbencho_tpu_torch.stats.cpu_util import CPUUtil
    proc_stat = [(0, 0)]
    for cls in (CPUUtil, JaxCPUUtil):
        monkeypatch.setattr(cls, "_read_proc_stat",
                            staticmethod(lambda: proc_stat[0]))
    port, jax = CPUUtil(), JaxCPUUtil()
    got = []
    for sample in ((0, 0), (0, 0), (30, 120), (30, 220), (130, 320)):
        proc_stat[0] = sample
        got.append((port.update(), jax.update()))
    assert got == [(0.0, 0.0), (0.0, 0.0), (25.0, 25.0), (0.0, 0.0),
                   (100.0, 100.0)]


# ----------------------------------------------------------------------
# cut phases, write errors, the config file
# ----------------------------------------------------------------------

def test_a_time_limited_phase_writes_its_row(tmp_path, capsys):
    """A phase cut by --timelimit prints and writes its rows; a chunk of
    the block loop or the ring that was cut books its ops and no
    latencies, so the histogram may count fewer values than ops."""
    path = sparse_file(tmp_path / "big.bin")
    csv, res = tmp_path / "out.csv", tmp_path / "res.txt"
    jf = tmp_path / "out.json"
    assert port_main(["-r", "-t", "2", "-b", "1M", "--iodepth", "2",
                      "--gpuids", "0", "--timelimit", "1", *OUTPUT_FLAGS,
                      "--csvfile", str(csv), "--resfile", str(res),
                      "--jsonfile", str(jf), str(path)],
                     device="cpu") == 0
    capsys.readouterr()
    (rec,) = records(jf)
    _, rows = csv_rows(csv.read_text().splitlines())
    assert [r["BytesLast"] for r in rows] == [str(rec["BytesLast"])]
    assert 0 < rec["BytesLast"] < 8 << 30
    ops = rec["BytesLast"] >> 20
    assert rec["IOLatHisto"]["LatNumValues"] <= ops
    assert any("IO latency us" in line
               for line in res.read_text().splitlines())


def test_a_sigint_phase_writes_its_row_before_rc_3(tmp_path):
    path = tmp_path / "f.bin"
    path.write_bytes(bytes(1 << 20))
    csv, res = tmp_path / "out.csv", tmp_path / "res.txt"
    child = spawn("port", ["-r", "-t", "2", "-b", "64K", "--gpuids", "0",
                           "--infloop", "--lat", "--nolive", "--csvfile",
                           str(csv), "--resfile", str(res), str(path)])
    try:
        read_until(child.stdout, "OPERATION")
        time.sleep(0.5)
        child.send_signal(signal.SIGINT)
        _out, err = child.communicate(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert child.returncode == 3, err
    _, rows = csv_rows(csv.read_text().splitlines())
    assert len(rows) == 1 and rows[0]["Phase"] == "READ"
    assert int(rows[0]["BytesLast"]) > 0
    assert res.read_text().splitlines()[1].startswith("READ ")


@pytest.mark.parametrize("flag", ["--resfile", "--csvfile", "--jsonfile"])
def test_a_result_file_that_cannot_be_written_fails_the_run(tmp_path,
                                                            capsys, flag):
    unwritable = tmp_path / "adir"
    unwritable.mkdir()
    (unwritable / "x").write_text("")  # a non-empty directory
    rc = port_main(["-w", "-s", "64K", "-b", "16K", "--nolive", flag,
                    str(unwritable), str(tmp_path / "f.bin")],
                   device="cpu")
    assert rc == 1
    assert "directory" in capsys.readouterr().err


def test_the_config_file_takes_the_output_flags(tmp_path, capsys):
    conf = tmp_path / "run.conf"
    csv = tmp_path / "out.csv"
    conf.write_text(f"lat = 1\nlatpercent = 1\nlatpercent9s = 3\n"
                    f"allelapsed = 1\ncpu = 1\nbase10 = 1\n"
                    f"csvfile = {csv}\nnocsvlabels = 1\n")
    texts = {}
    for pkg, main in (("jax", jax_main),
                      ("port", lambda a: port_main(a, device="cpu"))):
        assert main(["-w", "-t", "2", "-s", "1M", "-b", "256K", "--nolive",
                     "-c", str(conf), str(tmp_path / f"{pkg}.bin")]) == 0
        texts[pkg] = table_lines(capsys.readouterr().out)
    assert row_labels(texts["port"][2:]) == row_labels(texts["jax"][2:],
                                                       renamed=True)
    assert "p99.9" in pcts(texts["port"])[0]
    assert any("Throughput MB/s" in line for line in texts["port"])
    # both wrote the fixed columns alone, so the one file takes both rows
    header, rows = csv_rows(csv.read_text().splitlines())
    assert tuple(header) == port_stats.CSV_RESULT_COLUMNS
    assert len(rows) == 2
