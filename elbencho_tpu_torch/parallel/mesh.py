"""Device mesh of the --gpuslice phase.

Reference: elbencho_tpu/parallel/mesh.py (``make_ingest_mesh``). The
("host", "chip") mesh mirrors the reference's hosts-by-threads work
partitioning. Here it is a plain grid of ``torch.device``s driven by one
process: the multi-host runtime of the JAX package (``init_multihost``)
goes with service mode, a later slice. The grid may name one device more
than once (mesh slots): CPU slots in the tests, and slots on one GPU
where a caller wants the redistribution's copies at n > 1 on a
single-card machine; the CLI builds its mesh over distinct devices.
"""

from __future__ import annotations

import numpy as np
import torch

from .slice_phase import MeshShapeError


class Mesh:
    """A (hosts, chips) grid of devices: ``devices`` is a numpy object
    array of torch.device, as the JAX mesh's ``devices`` is of jax
    devices."""

    axis_names = ("host", "chip")

    def __init__(self, grid: np.ndarray):
        self.devices = grid

    @property
    def shape(self) -> "tuple[int, int]":
        return self.devices.shape


def default_devices() -> "list[torch.device]":
    """Every CUDA device of the machine; raises without one."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the slice mesh needs CUDA devices, but "
            "torch.cuda.is_available() is false (pass the devices, e.g. "
            "CPU slots, to run on the CPU)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_ingest_mesh(devices: "list | None" = None,
                     num_hosts: "int | None" = None,
                     shape: "tuple[int, int] | None" = None) -> Mesh:
    """2D ("host", "chip") mesh over the given devices (default: every
    CUDA device). Without ``num_hosts`` or ``shape`` the devices are
    factored into the most balanced grid, so both axes are exercised. An
    explicit ``shape`` (hosts, chips), the --meshshape knob, must cover the
    device count exactly; a geometry that does not fit raises
    MeshShapeError naming the offending axis."""
    if devices is None:
        devices = default_devices()
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if shape is not None:
        num_hosts, chips_per_host = shape
        if num_hosts * chips_per_host != n:
            # name the axis that cannot be satisfied so the error is
            # actionable: the host axis when it alone misfits the device
            # count, else the chip axis
            if n % num_hosts:
                axis, size = "host", num_hosts
            else:
                axis, size = "chip", chips_per_host
            raise MeshShapeError(
                f"--meshshape {num_hosts}x{chips_per_host} does not fit "
                f"{n} device(s): the \"{axis}\" axis of size {size} "
                f"requires hosts*chips == {n}")
    else:
        if num_hosts is None:
            # most balanced factorization h*c == n with h <= c
            num_hosts = 1
            for h in range(int(np.sqrt(n)), 0, -1):
                if n % h == 0:
                    num_hosts = h
                    break
        if n % num_hosts:
            raise MeshShapeError(
                f"device count {n} is not divisible by the \"host\" axis "
                f"({num_hosts} processes): every host must own the same "
                f"number of chips for the (\"host\", \"chip\") mesh")
        chips_per_host = n // num_hosts
    grid = np.empty(num_hosts * chips_per_host, dtype=object)
    grid[:] = devices[:num_hosts * chips_per_host]
    return Mesh(grid.reshape(num_hosts, chips_per_host))
