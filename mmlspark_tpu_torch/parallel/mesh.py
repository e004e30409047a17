"""Device meshes (port of `mmlspark_tpu/parallel/mesh.py`).

The reference names its topology with `jax.sharding.Mesh` and runs one
program over it with `shard_map`. Here a `Mesh` is an ndarray of
`torch.device`s with axis names; the code that runs on it (ring and
Ulysses attention, the context-parallel trainer, the data-parallel GBDT
fit) loops over the positions itself, places each shard on its
position's device and moves tensors between positions with
`.to(device)`. A sharding (`row_sharding`, `replicated`) names a layout
as the reference's `NamedSharding` does; `put` places a tensor in it,
one tensor per position.

One device may fill several positions when the caller lists it several
times (`devices=[torch.device("cuda:0")] * 4`): a sequence axis of 4 on
one card then runs the same ring program four cards would run, as the
reference's tests run theirs on 8 virtual CPU devices. Moving a tensor
between two positions of one device costs nothing. The constructors
never repeat a device on their own.

The data axis may span processes (`data_mesh` in a job that
`parallel.cluster.initialize_cluster` formed): with P processes of L
local positions each, global position q belongs to process q // L. Each
process holds tensors only for its own positions: `devices` and
`axis_devices` list the local ones, `mesh.shape["data"]` is the global
size, and `mesh.exchange` (a `cluster.Exchange`) gathers the positions'
tensors across processes. The GBDT fit runs over such a mesh; the LM
trainers and ring attention take one process's mesh only (ROADMAP item
15(g)). A mesh of one process behaves as a single-controller mesh.

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
from . import cluster

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"   # pipeline stages (GPipe microbatch schedule)


class Mesh:
    """An ndarray of `torch.device`s with one name per axis.
    `mesh.shape[axis]` is the axis' size, as in JAX. With
    `process_count` > 1 the data axis spans that many processes: `devices`
    holds this process's positions (`process_index`'s block of the data
    axis) and `exchange` gathers across processes (module docstring)."""

    def __init__(self, devices, axis_names: Sequence[str],
                 process_count: int = 1, process_index: int = 0,
                 exchange=None):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"a mesh of shape {devices.shape} needs "
                             f"{devices.ndim} axis names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names must differ: {axis_names}")
        if process_count > 1 and (DATA_AXIS not in axis_names
                                  or exchange is None):
            raise ValueError("only a data axis spans processes, with an "
                             "exchange (data_mesh)")
        self.devices = devices
        self.axis_names = axis_names
        self.process_count = int(process_count)
        self.process_index = int(process_index)
        self.exchange = exchange

    @property
    def shape(self) -> dict:
        shape = dict(zip(self.axis_names, self.devices.shape))
        if self.process_count > 1:
            shape[DATA_AXIS] *= self.process_count
        return shape

    @property
    def local_positions(self) -> int:
        """This process's positions on the data axis (all of them with
        one process)."""
        return self.devices.shape[self.axis_names.index(DATA_AXIS)]

    @property
    def position_offset(self) -> int:
        """The global index of this process's first data position."""
        return self.process_index * self.local_positions

    def single_process(self, what: str) -> None:
        """Raise where `what` runs over one process's mesh only."""
        if self.process_count > 1:
            raise NotImplementedError(
                f"{what} over a mesh that spans {self.process_count} "
                f"processes is not ported yet (ROADMAP Queue 1 item "
                f"15(g)); the GBDT fit is")

    def axis_devices(self, axis: str) -> list:
        """The devices along `axis` with every other axis at position 0:
        where a program sharded over `axis` alone runs (the others hold
        replicas). On a data axis that spans processes, this process's
        positions only."""
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
        procs = (f", process {self.process_index} of {self.process_count}"
                 if self.process_count > 1 else "")
        return (f"Mesh({dict(self.shape)}, "
                f"devices={[str(d) for d in self.devices.flat]}{procs})")


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


def device_count() -> int:
    """The positions `data_mesh()` makes: one card per process in a
    multi-process job, else every visible card."""
    if cluster.process_count() > 1:
        return cluster.process_count()
    return torch.cuda.device_count()


def data_mesh(n_devices: Optional[int] = None, devices=None,
              span_processes: Optional[bool] = None) -> Mesh:
    """1-D mesh over the `data` axis: the visible CUDA devices (or the
    first n of them), or the caller's `devices`.

    In a multi-process job (`cluster.initialize_cluster`) the axis spans
    the processes unless `span_processes=False`: `devices` (default: the
    process's card, `cluster.local_device()`) are this process's
    positions, and `n_devices`, when given, counts the positions of all
    processes."""
    procs = cluster.process_count() if span_processes is not False else 1
    if procs > 1:
        if n_devices is not None and n_devices % procs:
            raise ValueError(f"{n_devices} positions do not split over "
                             f"{procs} processes")
        local = None if n_devices is None else n_devices // procs
        if devices is None:
            if local not in (None, 1):
                raise ValueError(
                    f"{local} positions a process need devices=: a process "
                    f"takes its own card (cluster.local_device())")
            devs = [cluster.local_device()]
        else:
            devs = _devices(local or len(devices), devices)
        return Mesh(_array(devs, (len(devs),)), (DATA_AXIS,),
                    process_count=procs,
                    process_index=cluster.process_index(),
                    exchange=cluster.Exchange())
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
    needs the true count (or `valid_row_mask`). On a mesh that spans
    processes `arr` is the whole table and each process keeps its
    positions' rows."""
    if not torch.is_tensor(arr):
        arr = np.asarray(arr)
    padded, n = pad_to_multiple(arr, mesh.shape[axis_name], 0)
    if mesh.process_count > 1:
        block = padded.shape[0] // mesh.process_count
        lo = mesh.process_index * block
        padded = padded[lo:lo + block]
    return row_sharding(mesh, axis_name, padded.ndim).put(padded), n


def valid_row_mask(n_padded: int, n_valid: int, device=None) -> torch.Tensor:
    """float32 {1, 0} mask of real against padding rows, on `device`
    (None = the card)."""
    return (torch.arange(n_padded, device=resolve_device(device))
            < n_valid).to(torch.float32)
