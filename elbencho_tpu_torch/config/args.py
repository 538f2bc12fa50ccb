"""Flag/config system of the port, cut to the file-mode slice.

Reference: elbencho_tpu/config/args.py (itself ProgArgs of upstream
elbencho). The table-driven registry is kept: each FLAG_DEFS row builds an
argparse flag and a BenchConfig field. Flags shared with the JAX package
keep its ``dest`` names and validation messages; the device flags are
upstream elbencho's ``--gpuids`` plus ``--gpu*`` counterparts of the JAX
package's ``--tpu*`` flags.

The slice runs one regular file (file mode) with write, read and delete
phases. Directory mode, block devices, striping over several files and
the remaining flags are later slices (ROADMAP.md queue A).
"""

from __future__ import annotations

import dataclasses
import os
import stat as stat_mod
from dataclasses import field

from ..phases import BenchPhase
from ..toolkits.units import parse_size, parse_uint_list


class ConfigError(ValueError):
    """Reference: ProgException for invalid argument combinations."""


# (flag, short, dest, kind, default, help); kind: bool | int | size | str
FLAG_DEFS = [
    ("write", "w", "run_create_files", "bool", False,
     "Run write phase (create files)"),
    ("read", "r", "run_read_files", "bool", False, "Run read phase"),
    ("delfiles", "F", "run_delete_files", "bool", False,
     "Run delete-files phase"),
    ("threads", "t", "num_threads", "int", 1,
     "Number of I/O worker threads"),
    ("size", "s", "file_size", "size", 0,
     "File size (unit suffixes allowed, e.g. 4K, 1M, 10g)"),
    ("block", "b", "block_size", "size", 1 << 20,
     "Number of bytes per read/write op"),
    ("iodepth", None, "io_depth", "int", 1,
     "I/O depth: staging slots per thread, and the depth of the "
     "in-flight device transfer ring"),
    ("rand", None, "use_random_offsets", "bool", False,
     "Random offsets instead of sequential"),
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
]

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
        if len(self.paths) != 1:
            raise ConfigError(
                "this port runs file mode on exactly one file (striping "
                "over several files is not ported yet)")
        self._detect_file_size()
        self.num_dataset_threads = self.num_threads
        if self.file_size and 0 < self.file_size < self.block_size:
            self.block_size = self.file_size
        self._reduce_file_size_to_block_multiple()
        if self.use_random_offsets:
            self.random_amount = self.file_size
        return self

    def _detect_file_size(self) -> None:
        """Auto-set the file size from an existing file so -s is
        optional, refuse a read-only -s larger than the file, and refuse
        a size of 0 (reference: prepareFileSize, ProgArgs.cpp:2193-2227).
        Directories and block devices are rejected: their modes are not
        ported yet."""
        path = self.paths[0]
        try:
            st = os.stat(path)
        except OSError:
            st = None  # created (empty) by the write phase
        if st is not None and not stat_mod.S_ISREG(st.st_mode):
            raise ConfigError(
                f"this port runs file mode on a regular file only (dir "
                f"mode and block devices are not ported yet): {path}")
        cur_size = st.st_size if st else 0
        if not self.file_size:
            if not cur_size and (self.run_read_files
                                 or self.run_create_files):
                raise ConfigError(
                    "file size must not be 0 when benchmark path is "
                    f"a file (give -s): {path}")
            self.file_size = cur_size
        elif not self.run_create_files and st is not None \
                and cur_size < self.file_size:
            raise ConfigError(
                f"given size to use is larger than detected size. "
                f"File: {path}; Detected size: {cur_size}; "
                f"Given size: {self.file_size}")

    def _reduce_file_size_to_block_multiple(self) -> None:
        """Random IO: a trailing partial block is trimmed with a note
        (reference: ProgArgs.cpp:1664-1676)."""
        if self.use_random_offsets and self.file_size and self.block_size \
                and (self.run_create_files or self.run_read_files) \
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
        if self.gpu_depth < 0:
            raise ConfigError("--gpudepth must be >= 0 (0 = use --iodepth)")
        if self.gpu_dispatch_budget_usec < 0:
            raise ConfigError("--gpubudget must be >= 0 (0 = no budget)")
        if (self.gpu_depth or self.gpu_dispatch_budget_usec) \
                and not self.gpu_ids:
            raise ConfigError(
                "--gpudepth/--gpubudget tune the GPU transfer pipeline — "
                "they need --gpuids")

    def enabled_phases(self) -> "list[BenchPhase]":
        """Ordered phase list: creates before reads before deletes
        (reference: Coordinator.cpp:311-334)."""
        p = []
        if self.run_create_files:
            p.append(BenchPhase.CREATEFILES)
        if self.run_read_files:
            p.append(BenchPhase.READFILES)
        if self.run_delete_files:
            p.append(BenchPhase.DELETEFILES)
        return p

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
        description="elbencho-tpu's storage benchmark, file mode, with "
                    "the device data path on an NVIDIA GPU (PyTorch/CUDA)")
    parser.add_argument("paths", nargs="*", help="Benchmark file")
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
