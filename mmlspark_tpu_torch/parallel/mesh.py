"""Device meshes (port of `mmlspark_tpu/parallel/mesh.py`, the part the
sequence-parallel slice uses).

The reference names its topology with `jax.sharding.Mesh` and runs one
program over it with `shard_map`: JAX drives every device of a mesh from
one Python process. The port keeps that single-controller form. A `Mesh`
is an ndarray of `torch.device`s with axis names; the code that runs on
it (ring and Ulysses attention, the context-parallel trainer) loops over
the positions itself, places each shard on its position's device and
moves tensors between positions with `.to(device)`.

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

Not ported yet: `row_sharding`, `shard_rows`, `replicated`,
`pad_to_multiple`, `valid_row_mask` and `full_mesh`, which the GBDT
scale-out needs (ROADMAP Queue 1 item 15).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

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
