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

A mesh may span processes (`data_mesh`, `grid_mesh` and `full_mesh` in a
job that `parallel.cluster.initialize_cluster` formed). Its positions are
laid out process-major, as the reference's `jax.devices()` orders them:
with P processes, process p owns the p-th of P contiguous blocks of the
flattened (C-order) grid, so that for (data, pipe, model) = (1, 2, 2) on
two processes the pipe axis spans them and for (data, model) = (2, 2)
the data axis does. Each process holds tensors for its own positions
only: `mesh.shape` is the global shape, `devices` the local block,
`grid` the global one with None at other processes' positions,
`process_of(...)` the owner of a position, and `mesh.exchange` (a
`cluster.Exchange`) moves tensors between processes. The GBDT fit, both
LM trainers and ring and Ulysses attention run over such a mesh. A mesh
of one process behaves as a single-controller mesh.

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
    `process_count` > 1, `devices` is the global grid with None at every
    position another process owns (process p owns the p-th contiguous
    block of the flattened grid; module docstring) and `exchange` moves
    tensors between processes."""

    def __init__(self, devices, axis_names: Sequence[str],
                 process_count: int = 1, process_index: int = 0,
                 exchange=None):
        grid = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names):
            raise ValueError(f"a mesh of shape {grid.shape} needs "
                             f"{grid.ndim} axis names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names must differ: {axis_names}")
        self.process_count = int(process_count)
        self.process_index = int(process_index)
        if grid.size % self.process_count:
            raise ValueError(
                f"a grid of {grid.size} positions {grid.shape} does not "
                f"split evenly over {self.process_count} processes")
        self._per = grid.size // self.process_count
        lo = self.process_index * self._per
        flat = grid.reshape(-1)
        for q, dev in enumerate(flat):
            if (dev is None) == (lo <= q < lo + self._per):
                raise ValueError(
                    f"position {q} of the flattened grid is "
                    f"{'missing its device' if dev is None else 'given a device'}"
                    f" on process {self.process_index}, which owns positions "
                    f"[{lo}, {lo + self._per})")
        if self.process_count > 1 and exchange is None:
            raise ValueError("a mesh over processes needs an exchange "
                             "(cluster.Exchange)")
        self.grid = grid
        self.axis_names = axis_names
        self.exchange = exchange
        self.devices = _local_block(grid, lo, self._per)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.grid.shape))

    @property
    def local_positions(self) -> int:
        """This process's positions on the data axis (all of them with
        one process)."""
        return self.devices.shape[self.axis_names.index(DATA_AXIS)]

    @property
    def position_offset(self) -> int:
        """The data coordinate of this process's first position."""
        first = np.unravel_index(self.process_index * self._per,
                                 self.grid.shape)
        return int(first[self.axis_names.index(DATA_AXIS)])

    def _index(self, coords) -> tuple:
        for axis, i in coords.items():
            if axis not in self.axis_names and i != 0:
                raise ValueError(f"mesh axes {self.axis_names} have no "
                                 f"{axis!r} axis for coordinate {i}")
        return tuple(int(coords.get(a, 0)) for a in self.axis_names)

    def process_of(self, **coords) -> int:
        """The process that owns the position at named coordinates (an
        axis left out at 0)."""
        flat = np.ravel_multi_index(self._index(coords), self.grid.shape)
        return int(flat) // self._per

    def is_local(self, **coords) -> bool:
        """Whether this process owns the position at named coordinates."""
        return self.process_of(**coords) == self.process_index

    def axis_devices(self, axis: str) -> list:
        """The devices along `axis` through this process's first
        position (with one process: every other axis at 0), this
        process's only: where a program sharded over `axis` alone runs
        (the other axes hold replicas)."""
        i = self.axis_names.index(axis)
        first = np.unravel_index(self.process_index * self._per,
                                 self.grid.shape)
        index = tuple(slice(None) if j == i else first[j]
                      for j in range(self.grid.ndim))
        return [d for d in self.grid[index] if d is not None]

    def device_at(self, **coords) -> torch.device:
        """The device of the position at named coordinates, an axis left
        out at 0: `mesh.device_at(pipe=s, model=j)`. A coordinate of an
        axis the mesh lacks must be 0 (a size-1 axis). A position of
        another process raises: its tensors live there."""
        index = self._index(coords)
        dev = self.grid[index]
        if dev is None:
            raise ValueError(
                f"position {dict(zip(self.axis_names, index))} belongs to "
                f"process {self.process_of(**coords)}, not to this process "
                f"({self.process_index} of {self.process_count}): its "
                f"tensors live there (mesh.is_local, mesh.process_of)")
        return dev

    def __repr__(self):
        procs = (f", process {self.process_index} of {self.process_count}"
                 if self.process_count > 1 else "")
        return (f"Mesh({dict(self.shape)}, "
                f"devices={[str(d) for d in self.devices.flat]}{procs})")


def _local_block(grid: np.ndarray, lo: int, per: int) -> np.ndarray:
    """Positions [lo, lo + per) of the flattened grid, shaped as the box
    they fill where they fill one ((1, ..., 1, m, trailing axes...)),
    else flat."""
    flat = grid.reshape(-1)[lo:lo + per]
    trailing = 1
    for k in range(grid.ndim - 1, -1, -1):
        if per <= trailing * grid.shape[k]:
            m, rem = divmod(per, trailing)
            if rem == 0 and grid.shape[k] % m == 0:
                return flat.reshape((1,) * k + (m,) + grid.shape[k + 1:])
            break
        trailing *= grid.shape[k]
    return flat


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


def _spanning(shape, axis_names, devices, what: str) -> Mesh:
    """A mesh of global `shape` over this job's processes, process-major:
    `devices` (default: this process's card when it owns one position)
    are this process's positions."""
    procs, rank = cluster.process_count(), cluster.process_index()
    n = math.prod(shape)
    if n % procs:
        raise ValueError(f"a grid of {n} positions {tuple(shape)} does not "
                         f"split evenly over {procs} processes")
    per = n // procs
    if devices is None:
        if per != 1:
            raise ValueError(
                f"{what}: {per} positions a process need devices=: a "
                f"process takes its own card (cluster.local_device())")
        devs = [cluster.local_device()]
    else:
        devs = _devices(per, devices)
    grid = np.empty(n, dtype=object)
    grid[rank * per:(rank + 1) * per] = devs
    return Mesh(grid.reshape(tuple(shape)), axis_names, process_count=procs,
                process_index=rank, exchange=cluster.Exchange())


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
        n = n_devices if n_devices is not None else procs * (
            1 if devices is None else len(devices))
        return _spanning((n,), (DATA_AXIS,), devices, "data_mesh")
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
    devices=[cuda:0] * 4: the four-card layout on one card.

    In a multi-process job the grid spans the processes: its positions
    are laid out process-major (the module docstring), `devices`
    (default: the process's card, where it owns one position) are this
    process's, and a grid whose size does not split evenly over the
    processes raises ValueError."""
    if cluster.process_count() > 1:
        return _spanning(tuple(shape), axis_names, devices, "grid_mesh")
    n = math.prod(shape)
    return Mesh(_array(_devices(n, devices), shape), axis_names)


def full_mesh(axis_names: Sequence[str], shape: Optional[Sequence[int]] = None,
              devices=None) -> Mesh:
    """A mesh over every device: by default all of them on the last axis
    and 1 on the others, as the reference's (in a multi-process job,
    every process's positions)."""
    if shape is None:
        procs = cluster.process_count()
        if procs > 1:
            n = procs * (1 if devices is None else len(devices))
        else:
            n = (torch.cuda.device_count() if devices is None
                 else len(devices))
            if n == 0:
                _devices(1, devices)   # raises: no card is visible
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
