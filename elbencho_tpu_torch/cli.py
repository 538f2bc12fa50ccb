"""CLI entry point of the port (reference: elbencho_tpu/cli.py,
source/Main.cpp:14-69): parse args, validate, run the local coordinator.

    # file mode: one file, or several files/block devices striped
    python -m elbencho_tpu_torch -w -r -t 2 -b 16M -s 4g --iodepth 4 \\
        --verify 7 --gpuids 0 --gpuverify [--gpudirect] /path/file [...]
    # dir mode: -n dirs of -N files per thread under each directory
    python -m elbencho_tpu_torch -d -w --stat -r -F -D -t 8 -n 1 -N 64 \\
        -s 16M -b 16M --verify 7 --gpuids 0 --gpuverify /path/dir
    # --gpubatch: one host->device copy per 16 blocks of a read
    python -m elbencho_tpu_torch -r -t 2 -b 1M --gpuids 0 --gpubatch 16 \\
        /path/file
    # --gpubench: host<->device copies without storage (no bench path)
    python -m elbencho_tpu_torch --gpubench --gpubenchpat both -t 2 \\
        -b 16M -s 4g --iodepth 4 [--gpudirect]
    # --gpuprofile: a torch.profiler trace per device phase, in DIR/NNN_*
    python -m elbencho_tpu_torch -r -b 16M --gpuids 0 --gpuverify \\
        --verify 7 --gpuprofile /path/traces /path/file
    # run control: loop the read for 60 s; or two iterations of the phases
    python -m elbencho_tpu_torch -r -t 2 -b 16M --iodepth 4 --gpuids 0 \\
        --infloop --timelimit 60 /path/file
    python -m elbencho_tpu_torch -w -r -i 2 --phasedelay 5 --label run1 \\
        -b 16M --gpuids 0 /path/file
    # result output: latency rows, CPU use, and the three result files
    python -m elbencho_tpu_torch -r -t 2 -b 16M --iodepth 4 --gpuids 0 \\
        --lat --latpercent --lathisto --allelapsed --cpu \\
        --resfile res.txt --csvfile res.csv --jsonfile res.json /path/file
    # custom tree: scan a real tree into a tree file, then run it (files
    # of 32 MiB and more are shared by the workers, block by block)
    python -m elbencho_tpu_torch --treescan /path/src --treefile tree.txt
    python -m elbencho_tpu_torch -w -r -t 2 -b 16M --iodepth 4 \\
        --gpuids 0 --treefile tree.txt [--treerand] [--treeroundrob] \\
        [--sharesize 32M] /path/dir
    # live statistics: a line every 500 ms (fullscreen per-worker view on
    # a terminal without --live1/--live1n), and the live CSV and JSON
    python -m elbencho_tpu_torch -r -t 2 -b 16M --iodepth 4 --gpuids 0 \\
        --infloop --timelimit 60 --liveint 500 --live1n --cpu \\
        --livecsv live.csv --livejson live.json --livejsonex /path/file
"""

from __future__ import annotations

import sys

from . import __version__
from .config.args import ConfigError, build_arg_parser, parse_cli
from .toolkits.units import format_bytes


def _print_dry_run(cfg) -> None:
    """--dryrun: show workload totals without running (reference:
    Statistics::printDryRunInfo, Statistics.cpp:2865). Touches no device."""
    from .phases import phase_name
    from .workers.manager import WorkerManager
    print("Dry run — workload overview:")
    print(f"  path type      : {cfg.bench_path_type.name}")
    print(f"  threads        : {cfg.num_threads}")
    print(f"  dataset threads: {cfg.num_dataset_threads}")
    if cfg.gpu_ids:
        print(f"  gpu ids        : {cfg.gpu_ids}")
    for phase in cfg.enabled_phases():
        entries, num_bytes = WorkerManager.get_phase_num_entries_and_bytes(
            cfg, phase)
        print(f"  {phase_name(phase):<10}: {entries} entries, "
              f"{format_bytes(num_bytes)}B")


def _run_tree_scan(cfg) -> int:
    """--treescan DIR --treefile OUT: write a tree file of a real
    directory tree (reference: --treescan and tools/elbencho-scan-path).
    The JAX package also lists an s3:// or gs:// bucket; that needs the
    object back ends, which the port does not have yet."""
    import os
    from .toolkits.file_tk import scan_tree, write_treefile
    if not cfg.tree_file_path:
        print("ERROR: --treescan requires --treefile OUT for the result",
              file=sys.stderr)
        return 1
    if cfg.tree_scan_path.startswith(("s3://", "gs://")):
        print(f"ERROR: --treescan of a bucket needs the S3/GCS object back "
              f"ends, which this port does not have yet: "
              f"{cfg.tree_scan_path}", file=sys.stderr)
        return 1
    if not os.path.isdir(cfg.tree_scan_path):
        print(f"ERROR: --treescan path is not a directory: "
              f"{cfg.tree_scan_path}", file=sys.stderr)
        return 1
    dirs, files, needs_b64 = scan_tree(cfg.tree_scan_path)
    write_treefile(cfg.tree_file_path, dirs, files, use_base64=needs_b64)
    total = sum(e.total_len for e in files.elems)
    print(f"Scanned {cfg.tree_scan_path}: {dirs.num_paths} dirs, "
          f"{files.num_paths} files, {format_bytes(total)}B total -> "
          f"{cfg.tree_file_path}")
    return 0


def main(argv: "list[str] | None" = None,
         device: "str | None" = None) -> int:
    """Run the benchmark. ``device`` overrides where the device contexts
    live: None means the CUDA devices of --gpuids; "cpu" is for callers
    that ask for the CPU explicitly (the tests)."""
    try:
        cfg, ns = parse_cli(argv)
    except (ConfigError, OSError) as err:
        print(f"ERROR: {err}", file=sys.stderr)
        return 1
    if ns.version:
        print(f"elbencho-tpu-torch {__version__} (PyTorch/CUDA device "
              f"data path)")
        return 0
    if not cfg.paths and not (cfg.run_gpu_bench or cfg.tree_scan_path):
        build_arg_parser().print_help()
        return 1
    try:
        cfg.derive()
        cfg.check()
    except (ConfigError, OSError) as err:
        print(f"ERROR: {err}", file=sys.stderr)
        return 1
    if cfg.csv_file_path:
        from .stats.statistics import Statistics
        try:  # fail before any phase runs, like the reference
            Statistics.check_csv_file_compatibility(cfg)
        except (ValueError, OSError) as err:
            print(f"ERROR: {err}", file=sys.stderr)
            return 1
    if cfg.tree_scan_path:
        return _run_tree_scan(cfg)
    if cfg.do_dry_run:
        _print_dry_run(cfg)
        return 0
    cfg.device = device
    from .coordinator import Coordinator
    return Coordinator(cfg).main()


if __name__ == "__main__":
    sys.exit(main())
