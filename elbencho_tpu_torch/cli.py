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
"""

from __future__ import annotations

import sys

from . import __version__
from .config.args import ConfigError, build_arg_parser, parse_cli


def main(argv: "list[str] | None" = None,
         device: "str | None" = None) -> int:
    """Run the benchmark. ``device`` overrides where the device contexts
    live: None means the CUDA devices of --gpuids; "cpu" is for callers
    that ask for the CPU explicitly (the tests)."""
    try:
        cfg, ns = parse_cli(argv)
    except ConfigError as err:
        print(f"ERROR: {err}", file=sys.stderr)
        return 1
    if ns.version:
        print(f"elbencho-tpu-torch {__version__} (PyTorch/CUDA device "
              f"data path)")
        return 0
    if not cfg.paths and not cfg.run_gpu_bench:
        build_arg_parser().print_help()
        return 1
    try:
        cfg.derive()
        cfg.check()
    except (ConfigError, OSError) as err:
        print(f"ERROR: {err}", file=sys.stderr)
        return 1
    cfg.device = device
    from .coordinator import Coordinator
    return Coordinator(cfg).main()


if __name__ == "__main__":
    sys.exit(main())
