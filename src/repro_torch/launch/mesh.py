"""Device meshes for the port (the twin of ``repro/launch/mesh.py``).

A :class:`Mesh` is an array of ``torch.device`` entries with a name for each
of its axes.  Nothing else drives the devices: the port is single-controller
like the reference (one process, one host thread launches every device's
work), and a mesh only says which device holds which block of a sharded
axis (:mod:`repro_torch.parallel.sharding`).  An entry may repeat a device:
a 2-way mesh over one card twice is a *degenerate* placement that runs every
sharded code path on a one-card host, as the reference's
``disjoint_submeshes`` reuses devices round-robin on a small host.

Functions, not module constants: importing this module touches no device.
``make_production_mesh`` and ``require_virtual_devices`` serve only the
reference's ``dryrun``, which the port has not yet.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import indexed, resolve_device


class Mesh:
    """``devices`` (an array of ``torch.device``, one axis per name; a CUDA
    entry without an index names the current card) and ``axis_names``.
    ``shape`` maps each axis name to its size, as the reference's
    ``Mesh.shape`` does."""

    def __init__(self, devices: Any, axis_names: Sequence[str]):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = indexed(src[idx])
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError(f"a mesh of shape {arr.shape} needs one name "
                             f"per axis, got {self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated mesh axis name in {self.axis_names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.devices = arr

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_list(self) -> List[torch.device]:
        """Every entry in row-major order (a device may repeat)."""
        return list(self.devices.reshape(-1))

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, "
                f"{[str(d) for d in self.device_list]})")


def visible_devices() -> List[torch.device]:
    """Every visible card, in index order; raises when there is none."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence[Any]] = None) -> Mesh:
    """A mesh of ``shape`` over ``devices`` (default: every visible card,
    in index order; raises when there is none).  ``devices`` may repeat a
    device, for a degenerate placement; it must hold exactly as many
    entries as the shape, or, when left out, at least as many cards (the
    first ones are taken)."""
    shape = tuple(int(n) for n in shape)
    need = int(np.prod(shape)) if shape else 1
    if devices is None:
        devs = visible_devices()
        if len(devs) < need:
            raise ValueError(f"a mesh of shape {shape} needs {need} "
                             f"devices, {len(devs)} visible")
        devs = devs[:need]
    else:
        devs = [torch.device(d) for d in devices]
        if len(devs) != need:
            raise ValueError(f"a mesh of shape {shape} needs {need} "
                             f"devices, got {len(devs)}")
    arr = np.empty((need,), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), axes)


def make_host_mesh(device: Any = None) -> Mesh:
    """1x1 (data, model) mesh on one device (``None`` means the card), for
    smoke tests and examples."""
    return make_mesh((1, 1), ("data", "model"),
                     devices=[resolve_device(device)])


@contextlib.contextmanager
def mesh_context(mesh: Mesh) -> Iterator[Mesh]:
    """The reference's ambient-mesh scope, kept so code written as ``with
    mesh_context(mesh):`` runs: it yields ``mesh`` and sets nothing.  The
    reference's ambient mesh tells XLA where ``with_sharding_constraint``
    places values; eager PyTorch has no such constraint
    (``parallel.sharding`` has no ``shard_constraint``), and the port's
    sharded engines take their mesh from their scheduler."""
    yield mesh
