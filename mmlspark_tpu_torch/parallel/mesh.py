"""Device meshes (port of `mmlspark_tpu/parallel/mesh.py`).

The reference names its topology with `jax.sharding.Mesh` and runs one
program over it with `shard_map`: JAX drives every device of a mesh from
one Python process. The port keeps that single-controller form. A `Mesh`
is an ndarray of `torch.device`s with axis names; the code that runs on
it (ring and Ulysses attention, the context-parallel trainer, the
data-parallel GBDT fit) loops over the positions itself, places each
shard on its position's device and moves tensors between positions with
`.to(device)`. A sharding (`row_sharding`, `replicated`) names a layout
as the reference's `NamedSharding` does; `put` places a tensor in it,
one tensor per position.

One device may fill several positions when the caller lists it several
times (`devices=[torch.device("cuda:0")] * 4`): a sequence axis of 4 on
one card then runs the same ring program four cards would run, as the
reference's tests run theirs on 8 virtual CPU devices. Moving a tensor
between two positions of one device costs nothing. The constructors
never repeat a device on their own.

Axis conventions, as in the reference:
    "data"  -- batch/row sharding (dp)
    "model" -- tensor parallelism (tp)
    "seq"   -- sequence/context parallelism (ring attention)
    "pipe"  -- pipeline stages
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"   # pipeline stages (GPipe microbatch schedule)


class Mesh:
    """An ndarray of `torch.device`s with one name per axis.
    `mesh.shape[axis]` is the axis' size, as in JAX."""

    def __init__(self, devices, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"a mesh of shape {devices.shape} needs "
                             f"{devices.ndim} axis names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names must differ: {axis_names}")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> list:
        """The devices along `axis` with every other axis at position 0:
        where a program sharded over `axis` alone runs (the others hold
        replicas)."""
        i = self.axis_names.index(axis)
        index = tuple(slice(None) if j == i else 0
                      for j in range(self.devices.ndim))
        return list(self.devices[index])

    def device_at(self, **coords) -> torch.device:
        """The device of the position at named coordinates, an axis left
        out at 0: `mesh.device_at(pipe=s, model=j)`. A coordinate of an
        axis the mesh lacks must be 0 (a size-1 axis)."""
        for axis, i in coords.items():
            if axis not in self.axis_names and i != 0:
                raise ValueError(f"mesh axes {self.axis_names} have no "
                                 f"{axis!r} axis for coordinate {i}")
        return self.devices[tuple(coords.get(a, 0)
                                  for a in self.axis_names)]

    def __repr__(self):
        return (f"Mesh({dict(self.shape)}, "
                f"devices={[str(d) for d in self.devices.flat]})")


def _devices(n: int, devices) -> list:
    """n devices: the first n visible CUDA devices when `devices` is None,
    else the first n of the caller's list (which may repeat a device)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible: a mesh uses the visible cards "
                "by default; pass devices=[...] (e.g. devices=['cpu'] * "
                f"{n}) to place its positions yourself")
        visible = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if n > len(visible):
            raise ValueError(
                f"a mesh of {n} positions needs {n} devices and "
                f"{len(visible)} CUDA device(s) are visible; pass devices= "
                f"to place several positions on one device (e.g. "
                f"devices=[torch.device('cuda:0')] * {n})")
        return visible[:n]
    devices = [torch.device(d) for d in devices]
    if n > len(devices):
        raise ValueError(f"a mesh of {n} positions needs {n} entries in "
                         f"devices=, got {len(devices)}")
    return devices[:n]


def _array(devs: list, shape) -> np.ndarray:
    out = np.empty(len(devs), dtype=object)
    out[:] = devs
    return out.reshape(tuple(shape))


def data_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over the `data` axis: the visible CUDA devices (or the
    first n of them), or the caller's `devices`."""
    if n_devices is None:
        n_devices = (torch.cuda.device_count() if devices is None
                     else len(devices))
        if n_devices == 0:
            _devices(1, devices)       # raises: no card is visible
    return Mesh(_array(_devices(n_devices, devices), (n_devices,)),
                (DATA_AXIS,))


def grid_mesh(shape: Sequence[int],
              axis_names: Sequence[str] = (DATA_AXIS, MODEL_AXIS),
              devices=None) -> Mesh:
    """N-D mesh, e.g. (dp, pp, tp, cp) = (1, 1, 1, 4) with
    devices=[cuda:0] * 4: the four-card layout on one card."""
    n = math.prod(shape)
    return Mesh(_array(_devices(n, devices), shape), axis_names)


def full_mesh(axis_names: Sequence[str], shape: Optional[Sequence[int]] = None,
              devices=None) -> Mesh:
    """A mesh over every device: by default all of them on the last axis
    and 1 on the others, as the reference's."""
    if shape is None:
        n = (torch.cuda.device_count() if devices is None
             else len(devices))
        if n == 0:
            _devices(1, devices)       # raises: no card is visible
        shape = (len(axis_names) - 1) * (1,) + (n,)
    return grid_mesh(shape, axis_names, devices=devices)


class NamedSharding(NamedTuple):
    """A layout on a mesh, as the reference's `NamedSharding(mesh, P(...))`:
    `spec[i]` names the mesh axis that dimension i is split over (None:
    not split); an empty spec is replicated. `put` places a tensor."""
    mesh: Mesh
    spec: tuple

    def devices(self) -> list:
        """The devices that hold a piece: one per position of the split
        axis (the other axes at position 0), or every distinct device of
        the mesh for a replicated layout."""
        split = [a for a in self.spec if a is not None]
        if not split:
            return list(dict.fromkeys(self.mesh.devices.flat))
        return self.mesh.axis_devices(split[0])

    def put(self, arr) -> list:
        """`arr` (numpy or tensor) in this layout: one tensor per entry of
        `devices()`, dimension i split into equal blocks along its axis.
        A block already on its device is a view, not a copy. Raises where
        the split dimension does not divide (`pad_to_multiple` first)."""
        t = torch.as_tensor(arr)
        devs = self.devices()
        split = [i for i, a in enumerate(self.spec) if a is not None]
        if not split:
            return [t.to(d) for d in devs]
        dim = split[0]
        if t.shape[dim] % len(devs):
            raise ValueError(
                f"dimension {dim} of size {t.shape[dim]} does not split "
                f"over {len(devs)} positions; pad it (pad_to_multiple)")
        return [b.to(d) for b, d in zip(t.chunk(len(devs), dim), devs)]


def row_sharding(mesh: Mesh, axis: str = DATA_AXIS,
                 ndim: int = 1) -> NamedSharding:
    """Axis 0 (rows) split over `axis`; the rest whole."""
    return NamedSharding(mesh, (axis,) + (None,) * (ndim - 1))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def pad_to_multiple(arr, multiple: int, axis: int = 0, fill=0):
    """Pad `axis` so that it splits evenly over `multiple` positions;
    returns (padded, original length), `arr` itself when nothing is
    missing. numpy in, numpy out, as the reference; a tensor is padded on
    its device."""
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    if torch.is_tensor(arr):
        shape = list(arr.shape)
        shape[axis] = rem
        return torch.cat([arr, torch.full(shape, fill, dtype=arr.dtype,
                                          device=arr.device)], axis), n
    pad_width = [(0, 0)] * arr.ndim
    pad_width[axis] = (0, rem)
    return np.pad(arr, pad_width, constant_values=fill), n


def shard_rows(mesh: Mesh, arr, axis_name: str = DATA_AXIS):
    """A host array (or a tensor) split by rows over the mesh, zero-padded
    where ragged: (one tensor per position on its device, the number of
    real rows). Padding rows are zeros, so any aggregate other than a sum
    needs the true count (or `valid_row_mask`)."""
    if not torch.is_tensor(arr):
        arr = np.asarray(arr)
    padded, n = pad_to_multiple(arr, mesh.shape[axis_name], 0)
    return row_sharding(mesh, axis_name, padded.ndim).put(padded), n


def valid_row_mask(n_padded: int, n_valid: int, device=None) -> torch.Tensor:
    """float32 {1, 0} mask of real against padding rows, on `device`
    (None = the card)."""
    return (torch.arange(n_padded, device=resolve_device(device))
            < n_valid).to(torch.float32)
