"""The port stands alone: no module of elbencho_tpu_torch, and none of
chip_smoke.py, chip_multigpu.py and chip_profile_records.py, imports JAX
or anything of the JAX package, or loads the JAX package's engine
library (csrc/libioengine.so): the port builds its own from
elbencho_tpu_torch/csrc/ioengine.cpp."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "elbencho_tpu")


def _port_sources():
    files = [os.path.join(REPO, name) for name in
             ("chip_smoke.py", "chip_multigpu.py",
              "chip_profile_records.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO,
                                                   "elbencho_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "__import__", "import_module") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_jax_package_import(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_reference_to_the_jax_engine_library(path):
    with open(path) as f:
        assert "libioengine.so" not in f.read()


def test_importing_the_cli_loads_no_jax():
    code = ("import sys, elbencho_tpu_torch.cli, "
            "elbencho_tpu_torch.cuda.device, elbencho_tpu_torch.ops.verify, "
            "elbencho_tpu_torch.coordinator, elbencho_tpu_torch.utils.native, "
            "elbencho_tpu_torch.workers.local_worker, "
            "elbencho_tpu_torch.workers.gpubench, "
            "elbencho_tpu_torch.workers.gpuslice, "
            "elbencho_tpu_torch.workers.manager, "
            "elbencho_tpu_torch.parallel.slice_phase, "
            "elbencho_tpu_torch.parallel.mesh, "
            "elbencho_tpu_torch.parallel.ingest, "
            "elbencho_tpu_torch.models.workloads, elbencho_tpu_torch.entry;"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'elbencho_tpu'));"
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
