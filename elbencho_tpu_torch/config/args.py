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
(TPUSLICE: striped shard ingest over a device mesh and redistribution).
Custom trees, the other storage back ends and the remaining flags are
later slices (ROADMAP.md queue A).
"""

from __future__ import annotations

import dataclasses
import os
import stat as stat_mod
from dataclasses import field

from ..phases import BenchPathType, BenchPhase
from ..toolkits.units import parse_size, parse_uint_list


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
    ("rand", None, "use_random_offsets", "bool", False,
     "Random offsets instead of sequential"),
    ("dirsharing", None, "do_dir_sharing", "bool", False,
     "All threads share the same dirs (d0..dN) instead of per-rank dirs"),
    ("verify", None, "integrity_check_salt", "int", 0,
     "Enable data integrity check with given salt (!=0)"),
    ("jsonfile", None, "json_file_path", "str", "",
     "Also write results to this JSON file"),
    ("nolive", None, "disable_live_stats", "bool", False,
     "Disable live statistics (accepted for command-line compatibility; "
     "this port prints no live statistics)"),
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
]

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
    """Typed effective configuration. Derived values (path type, device
    ids, random amount) are computed by derive()."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.gpu_ids: "list[int]" = []
        self.bench_path_type: BenchPathType = BenchPathType.DIR
        self.num_dataset_threads: int = self.num_threads
        self.random_amount = 0
        self.bench_path_fds: "list[int]" = []   # opened by the manager
        # torch device override for the device contexts: None runs on
        # cuda:<gpu id>; "cpu" is for callers that ask for the CPU
        # explicitly (the tests). Deliberately no flag.
        self.device: "str | None" = None

    # -- derivation ---------------------------------------------------------

    def derive(self) -> "BenchConfig":
        self.gpu_ids = parse_uint_list(self.gpu_ids_str)
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
        if self.use_random_offsets:
            # default random amount = full dataset size: one file's size
            # in dir mode, the striped range over all paths otherwise
            if self.bench_path_type != BenchPathType.DIR:
                self.random_amount = self.file_size * max(1, len(self.paths))
            else:
                self.random_amount = self.file_size
        return self

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
        """Random IO and the slice phase: a trailing partial block is
        trimmed with a note (reference: ProgArgs.cpp:1664-1676); a shard
        block straddling a file boundary would short-read."""
        if (self.use_random_offsets or self.run_gpu_slice) \
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
        if self.run_gpu_slice:
            if self.bench_path_type == BenchPathType.DIR:
                raise ConfigError(
                    "--gpuslice requires file/blockdev bench paths (a "
                    "directory tree is not striped over chips)")
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
        if kind == "bool":
            parser.add_argument(*names, dest=dest, action="store_true",
                                default=default, help=help_txt)
        else:
            parser.add_argument(*names, dest=dest, metavar="V",
                                type=_KIND_PARSERS[kind], default=default,
                                help=help_txt)
    return parser


def parse_cli(argv: "list[str] | None" = None) -> "tuple[BenchConfig, object]":
    """Parse CLI into (BenchConfig, raw_namespace)."""
    import sys as sys_mod
    parser = build_arg_parser()
    argv = list(sys_mod.argv[1:]) if argv is None else list(argv)
    ns = parser.parse_args(argv)
    field_names = {f.name for f in dataclasses.fields(BenchConfig)}
    kwargs = {k: v for k, v in vars(ns).items() if k in field_names}
    return BenchConfig(**kwargs), ns
