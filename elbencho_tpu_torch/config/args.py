"""Flag/config system of the port, cut to the POSIX paths it runs.

Reference: elbencho_tpu/config/args.py (itself ProgArgs of upstream
elbencho). The table-driven registry is kept: each FLAG_DEFS row builds an
argparse flag and a BenchConfig field. Flags shared with the JAX package
keep its ``dest`` names and validation messages; the device flags are
upstream elbencho's ``--gpuids`` plus ``--gpu*`` counterparts of the JAX
package's ``--tpu*`` flags.

The port runs POSIX bench paths of one type: directories (dir mode,
``-n`` dirs of ``-N`` files per thread), or regular files or block
devices (file mode, striped over several paths), with the MKDIRS,
STATDIRS, WRITE, STAT, READ, RMFILES and RMDIRS phases, and the
``--gpubench`` phase (TPUBENCH: host<->device copies and the collective
patterns), which needs no bench path, and the ``--gpuslice`` phase
(TPUSLICE: striped shard ingest over a device mesh and redistribution),
under the run control flags (``-i``, ``--timelimit``, ``--infloop``,
``--phasedelay``, ``--label``, ``--dryrun``, ``-c``) and the result
output flags (``--lat``, ``--lathisto``, ``--latpercent``,
``--latpercent9s``, ``--allelapsed``, ``--cpu``, ``--base10``,
``--no0usecerr``, ``--resfile``, ``--csvfile``, ``--jsonfile``,
``--nocsvlabels`` and the default result files) and the live statistics
flags (``--nolive``, ``--liveint``, ``--live1``, ``--live1n``,
``--livecsv``, ``--livejson``, ``--livecsvex``, ``--livejsonex``) and
the data-plane fault tolerance flags (``--ioretries``,
``--ioretrybudget``, ``--iotimeout``, ``--gpufallback``; the test-only
``ELBENCHO_TPU_IO_FAULT`` knob is refused outside
``ELBENCHO_TPU_TESTING=1``) and the mixed and rate-shaped traffic flags
(``--rwmixpct``, ``--rwmixthr``, ``--rwmixthrpct``, ``--limitread``,
``--limitwrite``, ``--blockvarpct``, ``--blockvaralgo``) and the
engine's last per-op features (``--flock``, ``--opslog``,
``--opsloglock``, ``--readinline``, ``--verifydirect``) and the custom
trees (``--treefile``, ``--treerand``, ``--treeroundrob``,
``--treeroundup``, ``--sharesize``, ``--treescan``) and memory-mapped
I/O (``--mmap``, ``--madv``, which also steers the staging slab's
hugepage ladder, and ``--fadv``) and direct I/O (``--direct``,
``--nodiocheck``, ``--nofdsharing``) and the access patterns
(``--randamount``, ``--norandalign``, ``--randalgo``, ``--backward``,
``--strided``, ``--shufflewindow``) and the file-lifecycle flags
(``--trunc``, ``--trunctosize``, ``--preallocfile``, ``--statinline``,
``--nodelerr``, the ``--sync`` and ``--dropcaches`` phases between the
others (``--dropcache`` is the reference's spelling), ``--dirstats``,
which the JAX package parses and reads nowhere, and ``--log``, the log
level) and worker placement (``--zones``, ``--cores``: each worker
thread bound round-robin to a NUMA zone, with its staging slabs, or to a
core; a list that does not parse fails each worker's preparation, as in
the JAX package). Bench paths take bash's ``{N..M}``
numeric ranges (``/mnt/f{1..4}`` is four paths) unless ``--nopathexp``.
The other storage back ends (and with them the bucket scan of
``--treescan``) and the remaining flags are later slices (ROADMAP.md
queue A).
"""

from __future__ import annotations

import dataclasses
import os
import stat as stat_mod
from dataclasses import field

from ..phases import BenchPathType, BenchPhase
from ..toolkits.units import parse_flag_list, parse_size, parse_uint_list


class ConfigError(ValueError):
    """Reference: ProgException for invalid argument combinations."""


# (flag, short, dest, kind, default, help); kind: bool | int | size | str
FLAG_DEFS = [
    ("write", "w", "run_create_files", "bool", False,
     "Run write phase (create files)"),
    ("read", "r", "run_read_files", "bool", False, "Run read phase"),
    ("mkdirs", "d", "run_create_dirs", "bool", False,
     "Run create-directories phase"),
    ("deldirs", "D", "run_delete_dirs", "bool", False,
     "Run delete-directories phase"),
    ("delfiles", "F", "run_delete_files", "bool", False,
     "Run delete-files phase"),
    ("stat", None, "run_stat_files", "bool", False,
     "Run stat/getattr phase"),
    ("statdirs", None, "run_stat_dirs", "bool", False,
     "Run stat-directories phase"),
    ("sync", None, "run_sync_phase", "bool", False,
     "Sync write caches to stable storage between phases"),
    ("dropcaches", None, "run_drop_caches_phase", "bool", False,
     "Drop kernel page/dentry/inode caches between phases"),
    ("threads", "t", "num_threads", "int", 1,
     "Number of I/O worker threads"),
    ("dirs", "n", "num_dirs", "int", 1,
     "Number of directories per thread (dir mode)"),
    ("files", "N", "num_files", "int", 1,
     "Number of files per directory (dir mode)"),
    ("size", "s", "file_size", "size", 0,
     "File size (unit suffixes allowed, e.g. 4K, 1M, 10g)"),
    ("block", "b", "block_size", "size", 1 << 20,
     "Number of bytes per read/write op"),
    ("iodepth", None, "io_depth", "int", 1,
     "I/O depth: staging slots per thread, and the depth of the "
     "in-flight device transfer ring"),
    ("ioengine", None, "io_engine", "str", "auto",
     "Native block-loop engine: auto|sync|aio|uring (auto = sync when "
     "iodepth is 1, kernel AIO otherwise)"),
    ("ioretries", None, "io_num_retries", "int", 0,
     "Per-op retries on transient storage errors (EINTR/EAGAIN/"
     "ETIMEDOUT/short reads, EIO on network filesystems; jittered "
     "exponential backoff; permanent errors like ENOSPC/EROFS still "
     "fail fast; 0 = fail on first error, the default)"),
    ("ioretrybudget", None, "io_retry_budget_secs", "int", 30,
     "Per-phase, per-worker cap on total I/O retry backoff seconds; "
     "when spent, the next transient error is final (--ioretries)"),
    ("iotimeout", None, "io_timeout_secs", "int", 0,
     "Per-op deadline in seconds for storage ops in the native "
     "streaming ring (--gpustream): a hung op is cancelled and "
     "surfaces as ETIMEDOUT — transient, so --ioretries can re-drive "
     "it on the re-armed slot (0 = no deadline)"),
    # access pattern
    ("rand", None, "use_random_offsets", "bool", False,
     "Random offsets instead of sequential"),
    ("randamount", None, "random_amount", "size", 0,
     "Total bytes to read/write in random mode (default: full size)"),
    ("norandalign", None, "no_random_align", "bool", False,
     "Do not align random offsets to block size"),
    ("randalgo", None, "rand_offset_algo", "str", "fast",
     "Random offset generator: strong|balanced_single|balanced|fast"),
    ("backward", None, "do_reverse_seq_offsets", "bool", False,
     "Do backward sequential reads/writes"),
    ("strided", None, "do_strided_access", "bool", False,
     "Strided access across shared files"),
    ("shufflewindow", None, "shuffle_window", "size", 0,
     "Read phases: emit block offsets as a seeded permutation within "
     "consecutive windows of this many bytes — every block exactly "
     "once, locality bounded by the window (the shuffle-buffer access "
     "shape of training input pipelines; the epochs scenario sets it "
     "per epoch with a per-epoch seed). 0 = off; incompatible with "
     "--rand/--backward/--strided/--mmap"),
    # file handling
    ("direct", None, "use_direct_io", "bool", False,
     "Use direct I/O (O_DIRECT), bypassing page cache"),
    ("nodiocheck", None, "no_direct_io_check", "bool", False,
     "Skip direct-I/O alignment sanity checks"),
    ("nofdsharing", None, "no_fd_sharing", "bool", False,
     "Each worker opens its own FDs for given file/bdev paths"),
    ("nopathexp", None, "no_path_expansion", "bool", False,
     "Disable {N..M} numeric range expansion in bench paths"),
    ("trunc", None, "do_truncate", "bool", False,
     "Truncate files to 0 on open for write"),
    ("trunctosize", None, "do_truncate_to_size", "bool", False,
     "Truncate files to full size on open for write"),
    ("preallocfile", None, "do_prealloc_file", "bool", False,
     "Preallocate file disk space on creation (fallocate)"),
    ("statinline", None, "do_stat_inline", "bool", False,
     "Stat each file inline during write/read phases"),
    ("dirsharing", None, "do_dir_sharing", "bool", False,
     "All threads share the same dirs (d0..dN) instead of per-rank dirs"),
    ("dirstats", None, "show_dirs_stats", "bool", False,
     "Show dirs/s in write phase results"),
    ("nodelerr", None, "ignore_delete_errors", "bool", False,
     "Do not treat deletion of non-existing files as error"),
    ("mmap", None, "use_mmap", "bool", False,
     "Use memory-mapped I/O instead of read/write syscalls"),
    ("flock", None, "use_file_locks", "str", "",
     "File range locking mode: range|full"),
    ("fadv", None, "fadvise_flags", "str", "",
     "posix_fadvise flags (comma-sep: seq,rand,willneed,dontneed,noreuse)"),
    ("madv", None, "madvise_flags", "str", "",
     "madvise flags (comma-sep: seq,rand,willneed,dontneed,hugepage,"
     "nohugepage) for --mmap file mappings; hugepage/nohugepage also "
     "steer the staging pool's slab (THP advice, or skipping the "
     "MAP_HUGETLB attempt)"),
    ("verify", None, "integrity_check_salt", "int", 0,
     "Enable data integrity check with given salt (!=0)"),
    ("verifydirect", None, "do_direct_verify", "bool", False,
     "Verify data by reading immediately after each write"),
    ("readinline", None, "do_read_inline", "bool", False,
     "Read each block immediately after writing it (same FD)"),
    ("blockvarpct", None, "block_variance_pct", "int", 0,
     "Percentage of each block to refill with random data between writes"),
    ("blockvaralgo", None, "block_variance_algo", "str", "fast",
     "PRNG for block variance: strong|balanced_single|balanced|fast"),
    # mixed reads and writes in the write phase
    ("rwmixpct", None, "rwmix_read_pct", "int", 0,
     "Percentage of reads in write phase (per-op modulo split)"),
    ("rwmixthr", None, "num_rwmix_read_threads", "int", 0,
     "Number of threads of the write phase that do reads instead"),
    ("rwmixthrpct", None, "rwmix_thr_read_pct", "int", 0,
     "Target read byte percentage for rwmixthr balancing"),
    # rate limiting
    ("limitread", None, "limit_read_bps", "size", 0,
     "Per-thread read bandwidth limit (bytes/sec, unit suffixes allowed)"),
    ("limitwrite", None, "limit_write_bps", "size", 0,
     "Per-thread write bandwidth limit (bytes/sec)"),
    ("no0usecerr", None, "ignore_0usec_errors", "bool", False,
     "Do not warn about operations completing in 0 microseconds"),
    # result output at the end of each phase
    ("lat", None, "show_latency", "bool", False,
     "Show min/avg/max latency"),
    ("lathisto", None, "show_latency_histogram", "bool", False,
     "Show latency histogram"),
    ("latpercent", None, "show_latency_percentiles", "bool", False,
     "Show latency percentiles"),
    ("latpercent9s", None, "num_latency_percentile_9s", "int", 2,
     "Number of nines for top latency percentile (2=99, 3=99.9, ...)"),
    ("allelapsed", None, "show_all_elapsed", "bool", False,
     "Show elapsed time of every single worker thread"),
    ("cpu", None, "show_cpu_util", "bool", False,
     "Show CPU utilization in live stats and results"),
    ("resfile", None, "res_file_path", "str", "",
     "Also write human-readable results to this file"),
    ("csvfile", None, "csv_file_path", "str", "",
     "Also write results to this CSV file"),
    ("jsonfile", None, "json_file_path", "str", "",
     "Also write results to this JSON file"),
    ("nocsvlabels", None, "no_csv_labels", "bool", False,
     "Do not print config labels line to CSV file"),
    ("log", None, "log_level", "int", 0,
     "Log level (0=normal, 1=verbose, 2=debug)"),
    ("base10", None, "use_base10_units", "bool", False,
     "Use base-10 (MB/s) instead of base-2 (MiB/s) units in output"),
    # live statistics during each phase
    ("livecsv", None, "live_csv_file_path", "str", "",
     "Write live stats to this CSV file ('stdout' allowed)"),
    ("livejson", None, "live_json_file_path", "str", "",
     "Write live stats to this JSON file ('stdout' allowed)"),
    ("livecsvex", None, "live_csv_extended", "bool", False,
     "Live CSV: one row per worker instead of totals"),
    ("livejsonex", None, "live_json_extended", "bool", False,
     "Live JSON: one entry per worker instead of totals"),
    ("liveint", None, "live_stats_interval_ms", "int", 2000,
     "Live statistics refresh interval in milliseconds"),
    ("live1", None, "use_single_line_live_stats", "bool", False,
     "Single-line live stats instead of fullscreen"),
    ("live1n", None, "single_line_live_stats_no_erase", "bool", False,
     "Single-line live stats, new line per update (for logs/pipes)"),
    ("nolive", None, "disable_live_stats", "bool", False,
     "Disable live statistics on the console (the --livecsv and "
     "--livejson files are still written)"),
    # GPU data path (upstream elbencho's --gpuids; the --gpu* flags are the
    # counterparts of the JAX package's --tpu* flags)
    ("gpuids", None, "gpu_ids_str", "str", "",
     "Comma-separated CUDA device ids for device-memory staging "
     "(round-robin worker->device by rank)"),
    ("gpudirect", None, "use_gpu_direct", "bool", False,
     "Copy straight between the page-locked (cudaHostRegister) I/O slots "
     "and device memory, skipping the pinned bounce buffer"),
    ("gpubatch", None, "gpu_batch_blocks", "int", 1,
     "Coalesce this many blocks into one host->device copy (amortizes "
     "per-transfer dispatch overhead; costs one host-side copy per block "
     "and defers the copy to every Nth block; rejected with --gpuverify "
     "— the aggregated span has no per-block on-device check)"),
    ("gpudepth", None, "gpu_depth", "int", 0,
     "In-flight device transfer ring depth (0 = ride --iodepth)"),
    ("gpubudget", None, "gpu_dispatch_budget_usec", "int", 0,
     "Fail the run when the measured per-block host-side dispatch "
     "overhead of the device transfer pipeline exceeds this many "
     "microseconds (0 = no budget)"),
    ("gpufallback", None, "gpu_fallback", "str", "abort",
     "Reaction to a GPU lost mid-phase (a sticky CUDA error): abort = "
     "fail fast (default); chip = drain+poison the failed GPU and "
     "redistribute its workers across surviving --gpuids GPUs "
     "(degrading to host staging when none survive); host = degrade "
     "straight to host-memory staging. Failovers are audited as "
     "TpuChipFailovers and flagged DEGRADED-TPU by summarize-json"),
    ("gpuverify", None, "do_gpu_verify", "bool", False,
     "Run integrity verification on the device (CUDA kernel) instead of "
     "the host"),
    ("gpuhbmpct", None, "gpu_hbm_limit_pct", "int", 90,
     "Max percentage of device memory to use for staging buffers"),
    ("gpustream", None, "gpu_stream", "str", "auto",
     "Fused storage<->device streaming loop: the native engine keeps up "
     "to --iodepth io_uring (or kernel-AIO) ops in flight over the "
     "staging slots while Python overlaps the device copies. auto = on "
     "where eligible with a logged fallback to the Python loop; on = "
     "required (fail loudly when ineligible); off = always use the "
     "Python loop"),
    ("gpuprofile", None, "gpu_profile_dir", "str", "",
     "Write a torch.profiler trace (Chrome trace of the host and the "
     "CUDA device timeline, for Perfetto) per device-touching phase into "
     "this directory"),
    ("gpubench", None, "run_gpu_bench", "bool", False,
     "Run GPU transfer benchmark (no storage; the netbench analogue over "
     "the device's host link: host<->device memory copies)"),
    ("gpubenchpat", None, "gpu_bench_pattern", "str", "h2d",
     "GPU bench pattern: h2d|d2h|both|ici|allgather|reducescatter|"
     "alltoall|psum (h2d = host->device copy per op, d2h = device->host, "
     "both = h2d followed by d2h per op; ici = ring permute; the rest time "
     "one collective per step over the devices of --gpuids, NCCL-perf-test "
     "style)"),
    ("gpuslice", None, "run_gpu_slice", "bool", False,
     "Run the slice phase: stripe the dataset off storage across every "
     "device of the mesh (each worker feeds its devices' shards through "
     "the staging slots + transfer pipeline), then redistribute each "
     "stripe across the devices (--redistspec), overlapping the next "
     "stripe's storage ingest with the previous stripe's redistribution "
     "— the sharded-checkpoint-restore shape (docs/pod-slice.md)"),
    ("meshshape", None, "mesh_shape_str", "str", "",
     "HOSTSxCHIPS mesh geometry for --gpuslice (e.g. 2x4); default: the "
     "most balanced 2D factorization of the device count"),
    ("redistspec", None, "redist_spec", "str", "alltoall",
     "--gpuslice redistribution target layout: alltoall (row-sharded -> "
     "column-sharded reshard, memory-constant; default) | host "
     "(all-gather within each host's devices) | chip (reshard onto the "
     "chip axis, replicated across hosts) | replicate (full all-gather)"),
    # run control
    ("iterations", "i", "iterations", "int", 1,
     "Number of iterations of the full phase set"),
    ("timelimit", None, "time_limit_secs", "int", 0,
     "Phase time limit in seconds"),
    ("infloop", None, "do_infinite_io_loop", "bool", False,
     "Let each worker loop its workload forever (until time limit/"
     "interrupt)"),
    ("phasedelay", None, "next_phase_delay_secs", "int", 0,
     "Delay between phases in seconds"),
    ("label", None, "bench_label", "str", "",
     "Custom benchmark label for result files"),
    ("dryrun", None, "do_dry_run", "bool", False,
     "Show workload totals and config without running any phase"),
    ("opslog", None, "ops_log_path", "str", "",
     "Log every single I/O operation as JSONL to this file"),
    ("opsloglock", None, "ops_log_lock", "bool", False,
     "Serialize ops log writes via file lock (for shared-file logs)"),
    ("configfile", "c", "config_file_path", "str", "",
     "Read benchmark settings from this file (ini-style: flag = value)"),
    # NUMA/core binding of the worker threads (utils/numa.py)
    ("zones", None, "numa_zones_str", "str", "",
     "Comma-separated NUMA zones to bind workers to (round-robin)"),
    ("cores", None, "cpu_cores_str", "str", "",
     "Comma-separated CPU cores to bind workers to (round-robin)"),
    # custom tree
    ("treefile", None, "tree_file_path", "str", "",
     "Path to custom tree file (see elbencho-tpu-scan-path)"),
    ("treerand", None, "use_custom_tree_rand", "bool", False,
     "Randomize custom tree file order"),
    ("treeroundrob", None, "use_custom_tree_round_robin", "bool", False,
     "Round-robin block assignment for shared custom tree files"),
    ("treeroundup", None, "tree_round_up_size", "size", 0,
     "Round file sizes in tree file up to multiple of this"),
    ("sharesize", None, "file_share_size", "size", 0,
     "Custom tree: files >= this size are shared between workers"),
    ("treescan", None, "tree_scan_path", "str", "",
     "Scan this directory tree — or an s3://bucket[/prefix] / gs:// "
     "bucket — and write a treefile (with --treefile OUT)"),
]

#: the reference's long-flag spellings that the port has the flags of,
#: accepted as aliases (alias -> the port's flag), as in the JAX package
REF_FLAG_ALIASES = {
    "dropcache": "dropcaches",       # reference: ARG_DROPCACHESPHASE_LONG
}

#: --gpubench patterns: host<->device copies, and the collectives
TRANSFER_PATTERNS = ("h2d", "d2h", "both")
COLLECTIVE_PATTERNS = ("ici", "allgather", "reducescatter", "alltoall",
                       "psum")

_KIND_PARSERS = {"int": int, "str": str, "size": parse_size}

_CONFIG_FIELDS = [
    (dest, {"bool": bool, "int": int, "str": str, "size": int}[kind],
     field(default=default))
    for _flag, _short, dest, kind, default, _help in FLAG_DEFS]
_CONFIG_FIELDS.append(("paths", list, field(default_factory=list)))

BenchConfigBase = dataclasses.make_dataclass("BenchConfigBase",
                                             _CONFIG_FIELDS)


class BenchConfig(BenchConfigBase):
    """Typed effective configuration. Derived values (the expanded
    paths, path type, device ids, the random amount's default) are
    computed by derive()."""

    #: the JAX package's bench mode: the port runs POSIX bench paths
    #: only (its object and netbench modes are later slices)
    bench_mode = "posix"

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.gpu_ids: "list[int]" = []
        self.bench_path_type: BenchPathType = BenchPathType.DIR
        self.num_dataset_threads: int = self.num_threads
        self.bench_path_fds: "list[int]" = []   # opened by the manager
        # torch device override for the device contexts: None runs on
        # cuda:<gpu id>; "cpu" is for callers that ask for the CPU
        # explicitly (the tests). Deliberately no flag.
        self.device: "str | None" = None
        # set by _apply_default_result_files: the CSV path was not given,
        # so a file of another column count is rotated, not refused
        self._defaulted_csv = False

    # -- derivation ---------------------------------------------------------

    def derive(self) -> "BenchConfig":
        self.gpu_ids = parse_uint_list(self.gpu_ids_str)
        if not self.no_path_expansion:
            self.paths = self._expand_path_braces(self.paths)
        self._find_bench_path_type()
        self._detect_blockdev_size()
        self._detect_file_size()
        self.num_dataset_threads = self.num_threads
        if self.file_size and 0 < self.file_size < self.block_size:
            self.block_size = self.file_size
        if self.run_gpu_slice and not self.file_size:
            # BEFORE the block-multiple trim below: a defaulted dataset
            # must honor the same stripe geometry as an explicit one
            self.file_size = 256 << 20
        self._reduce_file_size_to_block_multiple()
        if self.run_gpu_bench:
            if not self.gpu_ids:
                self.gpu_ids = [0]  # default to the first GPU
            if not self.file_size:
                self.file_size = 256 << 20  # sensible default amount
        if self.use_random_offsets and not self.random_amount:
            # an explicit --randamount stays; the default random amount is
            # the full dataset size: one file's size in dir mode, the
            # striped range over all paths otherwise
            if self.bench_path_type != BenchPathType.DIR:
                self.random_amount = self.file_size * max(1, len(self.paths))
            else:
                self.random_amount = self.file_size
        self._apply_default_result_files()
        return self

    @staticmethod
    def _default_results_base() -> str:
        """Base dir for default result files (separate hook for tests)."""
        return "/var/tmp"

    def _apply_default_result_files(self) -> None:
        """Runs default result files into
        /var/tmp/elbencho-tpu_results_<user>/ with date-stamped names
        (reference: RESFILE_DIR_USER_DEFAULT, ProgArgs.cpp:71,1174-1187),
        the same directory and names as the JAX package. Disable with
        ELBENCHO_TPU_NO_DEFAULT_RESFILES=1 (CI, test runs)."""
        if os.environ.get("ELBENCHO_TPU_NO_DEFAULT_RESFILES") == "1":
            return
        if self.res_file_path and self.csv_file_path \
                and self.json_file_path:
            return
        import datetime
        import getpass
        try:
            user = getpass.getuser()
        except (KeyError, OSError):
            user = f"uid{os.getuid()}"
        res_dir = os.path.join(self._default_results_base(),
                               f"elbencho-tpu_results_{user}")
        try:
            os.makedirs(res_dir, mode=0o700, exist_ok=True)
            # /var/tmp is world-writable and the dir name predictable: only
            # trust a real directory owned by us (no attacker symlink/dir)
            st = os.lstat(res_dir)
            if not stat_mod.S_ISDIR(st.st_mode) or st.st_uid != os.getuid():
                return
        except OSError:
            return  # read-only /var/tmp: keep explicit-only result files
        date = datetime.date.today().strftime("%Y%m%d")
        if not self.res_file_path:
            self.res_file_path = \
                f"{res_dir}/elbencho-tpu_results_{date}.txt"
        if not self.csv_file_path:
            self.csv_file_path = \
                f"{res_dir}/elbencho-tpu_results_{date}.csv"
            # an implicit file may be rotated on column-count mismatch
            # (a JAX-package run or another flag set must not fail runs
            # that never asked for CSV output; explicit --csvfile errors)
            self._defaulted_csv = True
        if not self.json_file_path:
            self.json_file_path = \
                f"{res_dir}/elbencho-tpu_results_{date}.json"

    @staticmethod
    def _expand_path_braces(paths: "list[str]") -> "list[str]":
        """"{N..M}" numeric range expansion in bench paths, bash style:
        counting down when M < N, zero-padded to the wider end when
        either end has a leading zero, several ranges of one path
        expanded left to right (reference: ProgArgs path expansion;
        --nopathexp turns it off)."""
        import re
        out: "list[str]" = []
        pattern = re.compile(r"\{(\d+)\.\.(\d+)\}")
        for p in paths:
            m = pattern.search(p)
            if not m:
                out.append(p)
                continue
            lo_str, hi_str = m.group(1), m.group(2)
            lo, hi = int(lo_str), int(hi_str)
            width = max(len(lo_str), len(hi_str)) \
                if lo_str.startswith("0") or hi_str.startswith("0") else 0
            step = 1 if hi >= lo else -1
            for i in range(lo, hi + step, step):
                out.extend(BenchConfig._expand_path_braces(
                    [p[:m.start()] + str(i).zfill(width) + p[m.end():]]))
        return out

    def _find_bench_path_type(self) -> None:
        """DIR|FILE|BLOCKDEV via stat; all paths must agree (reference:
        findBenchPathType, ProgArgs.cpp:3062). A path that does not exist
        is a file that the write phase creates."""
        types = set()
        for p in self.paths:
            try:
                st = os.stat(p)
                if stat_mod.S_ISDIR(st.st_mode):
                    types.add(BenchPathType.DIR)
                elif stat_mod.S_ISBLK(st.st_mode):
                    types.add(BenchPathType.BLOCKDEV)
                else:
                    types.add(BenchPathType.FILE)
            except FileNotFoundError:
                types.add(BenchPathType.FILE)
        if len(types) > 1:
            raise ConfigError(
                f"all bench paths must have the same type, got: "
                f"{[t.name for t in types]}")
        self.bench_path_type = types.pop() if types else BenchPathType.DIR

    def _detect_blockdev_size(self) -> None:
        """Blockdev mode: detect the device size (the smallest of the
        paths) so -s is optional, and refuse a -s larger than the device
        (reference: prepareBenchPathFDsVec, ProgArgs.cpp:2306-2330)."""
        if self.bench_path_type != BenchPathType.BLOCKDEV:
            return
        dev_size = None
        for p in self.paths:
            try:
                fd = os.open(p, os.O_RDONLY)
            except OSError as err:
                raise ConfigError(
                    f"unable to open block device {p}: {err.strerror}") \
                    from err
            try:
                size = os.lseek(fd, 0, os.SEEK_END)
            except OSError as err:
                raise ConfigError(
                    f"unable to check size of block device through lseek: "
                    f"{p}: {err.strerror}") from err
            finally:
                os.close(fd)
            if not size:
                raise ConfigError(f"block device size seems to be 0: {p}")
            dev_size = size if dev_size is None else min(dev_size, size)
        if not self.file_size:
            from ..toolkits.logger import LOG_NORMAL, log
            log(LOG_NORMAL,
                f"NOTE: Setting file size to block dev size: {dev_size}")
            self.file_size = dev_size
        elif self.file_size > dev_size:
            raise ConfigError(
                f"given size to use is larger than detected block device "
                f"size. Detected size: {dev_size}; "
                f"Given size: {self.file_size}")

    def _detect_file_size(self) -> None:
        """File mode: auto-set the file size from the first existing file
        so -s is optional, refuse a read-only -s larger than a file, and
        refuse a size of 0 (reference: prepareFileSize,
        ProgArgs.cpp:2193-2227)."""
        if self.bench_path_type != BenchPathType.FILE:
            return
        detected = bool(self.file_size)
        for p in self.paths:
            try:
                st = os.stat(p)
            except OSError:
                st = None  # created (empty) by the write phase
            cur_size = st.st_size if st else 0
            if not detected:
                detected = True
                if not cur_size and (self.run_read_files
                                     or self.run_create_files):
                    raise ConfigError(
                        "file size must not be 0 when benchmark path is "
                        f"a file (give -s): {p}")
                from ..toolkits.logger import LOG_NORMAL, log
                log(LOG_NORMAL,
                    f"NOTE: Auto-setting file size. Size: {cur_size}; "
                    f"Path: {p}")
                self.file_size = cur_size
            elif not self.run_create_files and st is not None \
                    and cur_size < self.file_size \
                    and stat_mod.S_ISREG(st.st_mode):
                raise ConfigError(
                    f"given size to use is larger than detected size. "
                    f"File: {p}; Detected size: {cur_size}; "
                    f"Given size: {self.file_size}")

    def _reduce_file_size_to_block_multiple(self) -> None:
        """Direct, random and strided IO and the slice phase: a trailing
        partial block is trimmed with a note (reference:
        ProgArgs.cpp:1664-1676); a block straddling a file boundary
        would short-read. Runs before the random amount's default, so
        that the amount is the trimmed dataset's."""
        if (self.use_direct_io or self.use_random_offsets
                or self.do_strided_access or self.run_gpu_slice) \
                and self.file_size and self.block_size \
                and (self.run_create_files or self.run_read_files
                     or self.run_gpu_slice) \
                and self.file_size % self.block_size:
            new_size = self.file_size - (self.file_size % self.block_size)
            from ..toolkits.logger import LOG_NORMAL, log
            log(LOG_NORMAL,
                "NOTE: File size has to be a multiple of block size for "
                "direct IO, random IO and strided IO. Reducing file size. "
                f"Old: {self.file_size}; New: {new_size}")
            self.file_size = new_size

    # -- validation ---------------------------------------------------------

    def check(self) -> None:
        if self.num_threads < 1:
            raise ConfigError("--threads must be >= 1")
        if self.block_size < 1 and self.file_size > 0:
            raise ConfigError("--block must be >= 1")
        if self.use_direct_io and not self.no_direct_io_check:
            align = 512
            if self.file_size % align or self.block_size % align:
                raise ConfigError(
                    "direct I/O requires file size and block size to be "
                    "multiples of 512 bytes (use --nodiocheck to override)")
        if self.bench_path_type != BenchPathType.DIR \
                and (self.run_create_dirs or self.run_delete_dirs
                     or self.run_stat_dirs):
            raise ConfigError(
                "directory phases (--mkdirs/--deldirs/--statdirs) require "
                "directory bench paths (path does not exist or is a file/"
                "blockdev)")
        if self.gpu_depth < 0:
            raise ConfigError("--gpudepth must be >= 0 (0 = use --iodepth)")
        if self.gpu_dispatch_budget_usec < 0:
            raise ConfigError("--gpubudget must be >= 0 (0 = no budget)")
        if (self.gpu_depth or self.gpu_dispatch_budget_usec) \
                and not self.gpu_ids and not self.run_gpu_bench \
                and not self.run_gpu_slice:
            raise ConfigError(
                "--gpudepth/--gpubudget tune the GPU transfer pipeline — "
                "they need --gpuids (or --gpubench/--gpuslice)")
        if not self.paths and any(
                phase != BenchPhase.TPUBENCH
                for phase in self.enabled_phases()):
            raise ConfigError(
                "the storage phases (-w/-r/-d/-D/-F/--stat/--statdirs/"
                "--gpuslice) need bench paths; only --gpubench runs "
                "without one")
        if self.madvise_flags:
            flags = parse_flag_list(self.madvise_flags)
            known = {"seq", "rand", "willneed", "dontneed", "hugepage",
                     "nohugepage"}
            unknown = [f for f in flags if f not in known]
            if unknown:
                raise ConfigError(
                    f"unknown --madv flag(s): {', '.join(unknown)} "
                    f"(valid: {', '.join(sorted(known))})")
            if "hugepage" in flags and "nohugepage" in flags:
                # one advice per region wins in the kernel: accepting
                # both would silently ignore one
                raise ConfigError(
                    "--madv hugepage and nohugepage are contradictory")
        if self.use_mmap and self.use_direct_io:
            raise ConfigError("--mmap and --direct are incompatible")
        if self.use_mmap and self.bench_path_type != BenchPathType.DIR \
                and len(self.paths) > 1:
            raise ConfigError(
                "--mmap supports a single file/blockdev path (striping "
                "across multiple mappings is not implemented)")
        if self.run_gpu_slice:
            if self.bench_path_type == BenchPathType.DIR:
                raise ConfigError(
                    "--gpuslice requires file/blockdev bench paths (a "
                    "directory tree is not striped over chips)")
            if self.use_mmap:
                raise ConfigError(
                    "--gpuslice reads shards through the staging pool; "
                    "incompatible with --mmap")
            if self.block_size % 4:
                raise ConfigError(
                    "--gpuslice shards are uint32 arrays: --block must "
                    "be a multiple of 4 bytes")
        from ..parallel.slice_phase import (REDIST_SPEC_NAMES,
                                            MeshShapeError, parse_mesh_shape)
        if self.redist_spec not in REDIST_SPEC_NAMES:
            raise ConfigError(
                f"--redistspec must be one of "
                f"{'|'.join(REDIST_SPEC_NAMES)}")
        if self.redist_spec != "alltoall" and not self.run_gpu_slice:
            raise ConfigError(
                "--redistspec shapes the --gpuslice redistribution "
                "target — it does nothing without --gpuslice")
        if self.mesh_shape_str:
            if not self.run_gpu_slice:
                raise ConfigError(
                    "--meshshape shapes the --gpuslice mesh — it does "
                    "nothing without --gpuslice")
            try:  # geometry vs device count is checked at phase time
                parse_mesh_shape(self.mesh_shape_str)
            except MeshShapeError as err:
                raise ConfigError(str(err)) from None
        if self.run_gpu_bench:
            if self.gpu_bench_pattern not in TRANSFER_PATTERNS \
                    + COLLECTIVE_PATTERNS:
                raise ConfigError(
                    f"unknown --gpubenchpat {self.gpu_bench_pattern!r} "
                    f"({'|'.join(TRANSFER_PATTERNS + COLLECTIVE_PATTERNS)})")
        if self.io_engine not in ("auto", "sync", "aio", "uring"):
            raise ConfigError("--ioengine must be auto|sync|aio|uring")
        if self.use_file_locks not in ("", "range", "full"):
            raise ConfigError("--flock must be range or full")
        if self.io_engine == "sync" and self.io_depth > 1:
            raise ConfigError("--ioengine sync requires --iodepth 1")
        if self.gpu_stream not in ("auto", "on", "off"):
            raise ConfigError("--gpustream must be auto|on|off")
        if self.gpu_stream == "on" and not self.gpu_ids \
                and not self.run_gpu_slice:
            raise ConfigError(
                "--gpustream on requires --gpuids or --gpuslice (the "
                "fused loop streams storage into GPU staging slots)")
        if self.gpu_stream == "on" and self.run_gpu_bench:
            # --gpubench does synthetic device transfers only and never
            # reaches the block loop: "on" would silently pass green
            raise ConfigError(
                "--gpustream on has no effect under --gpubench (no "
                "storage loop to fuse); drop one of the two")
        if self.gpu_stream == "on" and self.use_mmap:
            # the mmap memcpy loop never reaches the block-sized file
            # loop, so it cannot honor the fail-loudly contract
            raise ConfigError(
                "--gpustream on requires the POSIX block I/O path "
                "(incompatible with --mmap and object/netbench modes); "
                "use --gpustream auto there")
        if self.io_num_retries < 0:
            raise ConfigError("--ioretries must be >= 0")
        if self.io_retry_budget_secs < 0:
            raise ConfigError("--ioretrybudget must be >= 0")
        if self.io_timeout_secs < 0:
            raise ConfigError("--iotimeout must be >= 0")
        if self.io_timeout_secs and self.bench_mode != "posix":
            raise ConfigError(
                "--iotimeout applies to the native streaming ring (POSIX "
                "block I/O); object/netbench transports already bound "
                "their requests via HTTP timeouts")
        if self.gpu_fallback not in ("abort", "chip", "host"):
            raise ConfigError("--gpufallback must be abort|chip|host")
        if self.gpu_fallback != "abort" and not self.gpu_ids_str \
                and not self.gpu_ids:
            raise ConfigError(
                "--gpufallback tunes the GPU failover path — it needs "
                "--gpuids")
        if os.environ.get("ELBENCHO_TPU_IO_FAULT") \
                and os.environ.get("ELBENCHO_TPU_TESTING") != "1":
            # deterministic fault injection is a test-only knob: a
            # benchmark run with it set would publish numbers corrupted
            # by design
            raise ConfigError(
                "ELBENCHO_TPU_IO_FAULT is a test-only fault-injection "
                "knob (docs/fault-tolerance.md); refusing to run with it "
                "set outside a test harness (ELBENCHO_TPU_TESTING=1)")
        if os.environ.get("ELBENCHO_TPU_IO_FAULT"):
            from ..utils.native import parse_fault_spec
            try:  # malformed specs fail at config time, not mid-phase
                parse_fault_spec(os.environ["ELBENCHO_TPU_IO_FAULT"])
            except ValueError as err:
                raise ConfigError(str(err)) from None
        if self.num_rwmix_read_threads and not self.run_create_files:
            raise ConfigError("--rwmixthr requires the write phase (-w)")
        if self.rwmix_read_pct and not (0 <= self.rwmix_read_pct <= 100):
            raise ConfigError("--rwmixpct must be in 0..100")
        if self.block_variance_pct and \
                not (0 <= self.block_variance_pct <= 100):
            raise ConfigError("--blockvarpct must be in 0..100")
        if self.num_rwmix_read_threads >= max(1, self.num_threads) \
                and self.num_rwmix_read_threads:
            raise ConfigError("--rwmixthr must be < number of threads")
        if self.integrity_check_salt and self.block_variance_pct:
            raise ConfigError("--verify and --blockvarpct are incompatible")
        if self.rwmix_thr_read_pct and not 0 < self.rwmix_thr_read_pct < 100:
            # the JAX package raises this text from the balancer's
            # constructor when the workers are set up
            raise ConfigError("read percentage must be in (0, 100)")
        from ..toolkits.random_algos import create_rand_algo
        try:  # the JAX package fails at the first worker's prepare
            create_rand_algo(self.block_variance_algo, seed=0)
        except ValueError as err:
            raise ConfigError(str(err)) from None
        if self.shuffle_window:
            if self.use_random_offsets or self.do_reverse_seq_offsets \
                    or self.do_strided_access or self.use_mmap:
                raise ConfigError(
                    "--shufflewindow drives its own offset permutation — "
                    "incompatible with --rand/--backward/--strided/--mmap")
            if self.block_size and self.shuffle_window < self.block_size:
                raise ConfigError(
                    "--shufflewindow must be at least one --block")
        if self.gpu_batch_blocks > 1 and self.do_gpu_verify:
            # the aggregated copy skips the per-block on-device check
            raise ConfigError(
                "--gpubatch > 1 cannot be combined with --gpuverify: the "
                "aggregated span has no per-block on-device check — drop "
                "one of the two")

    def enabled_phases(self) -> "list[BenchPhase]":
        """Ordered phase list: creates before reads before the slice
        phase before deletes, dirs around files, the transfer benchmark
        last (reference: Coordinator.cpp:311-334)."""
        wanted = (
            (self.run_create_dirs, BenchPhase.CREATEDIRS),
            (self.run_stat_dirs, BenchPhase.STATDIRS),
            (self.run_create_files, BenchPhase.CREATEFILES),
            (self.run_stat_files, BenchPhase.STATFILES),
            (self.run_read_files, BenchPhase.READFILES),
            # after the read phase, before deletes: the slice phase reads
            # the striped dataset the write phase of this run created
            (self.run_gpu_slice, BenchPhase.TPUSLICE),
            (self.run_delete_files, BenchPhase.DELETEFILES),
            (self.run_delete_dirs, BenchPhase.DELETEDIRS),
            (self.run_gpu_bench, BenchPhase.TPUBENCH),
        )
        return [phase for enabled, phase in wanted if enabled]

    def config_labels(self) -> "dict[str, str]":
        """Flat config key/value labels for the JSON results."""
        out = {}
        for f in dataclasses.fields(self):
            val = getattr(self, f.name)
            if isinstance(val, list):
                val = ",".join(str(v) for v in val)
            out[f.name] = str(val)
        return out


def build_arg_parser():
    import argparse
    parser = argparse.ArgumentParser(
        prog="python -m elbencho_tpu_torch", allow_abbrev=False,
        description="elbencho-tpu's storage benchmark (dir mode, or file "
                    "mode on files or block devices) with the device data "
                    "path on an NVIDIA GPU (PyTorch/CUDA)")
    parser.add_argument("paths", nargs="*",
                        help="Benchmark paths: directories (dir mode), or "
                             "files or block devices (file mode, striped "
                             "over all paths); all of one type")
    parser.add_argument("--version", action="store_true",
                        help="Show version")
    for flag, short, dest, kind, default, help_txt in FLAG_DEFS:
        names = [f"--{flag}"] + ([f"-{short}"] if short else [])
        names += [f"--{alias}" for alias, target in REF_FLAG_ALIASES.items()
                  if target == flag]
        if kind == "bool":
            parser.add_argument(*names, dest=dest, action="store_true",
                                default=default, help=help_txt)
        else:
            parser.add_argument(*names, dest=dest, metavar="V",
                                type=_KIND_PARSERS[kind], default=default,
                                help=help_txt)
    return parser


def _apply_config_file(cfg_path: str, namespace, parser) -> None:
    """ini-style "flag = value" config file merge (reference: --configfile,
    docs/example_configuration/random-write.elbencho). The keys are the
    port's flag names; a flag given on the command line wins (a value
    equal to its default counts as not given, as in the JAX package)."""
    defaults = parser.parse_args([])
    with open(cfg_path) as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith(("#", ";", "[")):
                continue
            key, _, val = line.partition("=")
            key, val = key.strip(), val.strip()
            match = next((fd for fd in FLAG_DEFS if fd[0] == key), None)
            if match is None:
                raise ConfigError(f"unknown flag in config file: {key!r}")
            _, _, dest, kind, _, _ = match
            if getattr(namespace, dest) != getattr(defaults, dest):
                continue
            if kind == "bool":
                parsed = val.lower() not in ("0", "false", "no", "")
            else:
                parsed = _KIND_PARSERS[kind](val)
            setattr(namespace, dest, parsed)


def parse_cli(argv: "list[str] | None" = None) -> "tuple[BenchConfig, object]":
    """Parse CLI into (BenchConfig, raw_namespace). Raises ConfigError, or
    OSError for a --configfile that cannot be read."""
    import sys as sys_mod
    parser = build_arg_parser()
    argv = list(sys_mod.argv[1:]) if argv is None else list(argv)
    ns = parser.parse_args(argv)
    if ns.config_file_path:
        _apply_config_file(ns.config_file_path, ns, parser)
    field_names = {f.name for f in dataclasses.fields(BenchConfig)}
    kwargs = {k: v for k, v in vars(ns).items() if k in field_names}
    return BenchConfig(**kwargs), ns
