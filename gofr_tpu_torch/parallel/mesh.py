"""Serving meshes: named axes over a list of devices that one process
drives.

Port of ``gofr_tpu/parallel/mesh.py``. The JAX package's serving is
single-controller: one process owns every chip of the mesh and GSPMD
inserts the collectives. The port keeps that design: a :class:`Mesh` is
the axis sizes and a flat list of ``torch.device`` in row-major order over
``AXES``; the list may repeat a device (on the CPU every entry is ``cpu``;
two shards may share one card).

Axes (jax-ml scaling-book convention): ``dp`` data parallelism, ``fsdp``
data parallelism with the weights sharded (gathered before use), ``sp``
sequence, ``pp`` pipeline, ``ep`` expert, ``tp`` tensor parallelism (heads
and the MLP's hidden dimension). Serving places over dp, fsdp and tp.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Sequence

import torch

AXES = ("dp", "fsdp", "sp", "pp", "ep", "tp")

_HOST_COUNT = re.compile(r"--xla_force_host_platform_device_count=(\d+)")


def visible_devices(platform: str) -> list[torch.device]:
    """The devices a mesh may be built over: every card on ``cuda``; on the
    ``cpu`` as many virtual host devices as
    ``--xla_force_host_platform_device_count`` in ``XLA_FLAGS`` names (the
    setting the JAX package's CPU backend reads), else one."""
    if platform == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if platform == "cpu":
        found = _HOST_COUNT.findall(os.environ.get("XLA_FLAGS", ""))
        return [torch.device("cpu")] * (int(found[-1]) if found else 1)
    raise ValueError(f"no devices for platform {platform!r} — use cuda or cpu")


def mesh_shape_for(
    n_devices: int,
    tp: int = 1,
    sp: int = 1,
    fsdp: int = 1,
    pp: int = 1,
    ep: int = 1,
) -> dict[str, int]:
    """Fill ``dp`` with whatever remains after the explicit axes."""
    denom = tp * sp * fsdp * pp * ep
    if n_devices % denom != 0:
        raise ValueError(
            f"{n_devices} devices not divisible by tp*sp*fsdp*pp*ep={denom}"
        )
    return {
        "dp": n_devices // denom, "fsdp": fsdp, "sp": sp,
        "pp": pp, "ep": ep, "tp": tp,
    }


class Mesh:
    """Axis sizes (all six axes, absent ones 1) over ``devices``, the flat
    row-major list over ``AXES``."""

    def __init__(self, shape: dict[str, int], devices: Sequence[torch.device]):
        self.shape = {a: int(shape.get(a, 1)) for a in AXES}
        self.devices = [torch.device(d) for d in devices]

    @property
    def size(self) -> int:
        return len(self.devices)

    def device(self, **coords: int) -> torch.device:
        """The device at ``coords`` (axis -> index; absent axes 0)."""
        flat = 0
        for axis in AXES:
            flat = flat * self.shape[axis] + coords.get(axis, 0)
        return self.devices[flat]


def make_mesh(
    shape: Optional[dict[str, int]] = None,
    devices: Optional[Sequence[torch.device]] = None,
) -> Mesh:
    """Build a named mesh. Default: every card, all on ``dp``."""
    devices = list(devices if devices is not None else visible_devices("cuda"))
    if shape is None:
        shape = mesh_shape_for(len(devices))
    total = 1
    for axis in AXES:
        total *= shape.get(axis, 1)
    if total != len(devices):
        raise ValueError(f"mesh shape {shape} needs {total} devices, have {len(devices)}")
    return Mesh(shape, devices)


def axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape.get(axis, 1)


def mesh_axes(mesh: Optional[Mesh]) -> Optional[dict[str, int]]:
    """The mesh's non-trivial axes as a plain dict ({"tp": 2, "dp": 4}):
    the shape ``/admin/engine``'s ``mesh``, ``gofr_tpu_mesh_axis_size`` and
    a flight record's ``mesh_axes`` carry. None for no mesh, {} for a mesh
    whose axes are all 1."""
    if mesh is None:
        return None
    return {a: s for a, s in mesh.shape.items() if s > 1}
