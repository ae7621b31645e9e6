"""Device meshes of the port.

Port of ``src/repro/launch/mesh.py`` without JAX.  A JAX ``Mesh`` is a
grid of devices in one process; ``Mesh`` here is its counterpart: an
array of ``torch.device`` objects over named axes (``(data, model)``, or
``(pod, data, model)`` for the pod layout the sharding rules know), in
which one device may repeat, with a ``shape`` mapping like
``Mesh.shape``.  The sharded executor (``distributed.sharded_search``)
splits a table into ``shape["data"]`` row shards and the data-parallel
train step (``train.step``) a batch into ``shape["data"]`` batch shards;
each shard runs on its device, so the shard count is a property of the
layout, not of the number of cards.

``make_host_mesh(data=n)`` lays its slots over the visible cards in
turn: with ``n = torch.cuda.device_count()`` it is one card a shard, the
counterpart of ``jax.make_mesh`` over every device, and on a one-card
machine every shard is on that card.  ``make_host_mesh(data=4,
device="cuda:0")`` (or ``device="cpu"``) puts every shard on one device
on any machine.

``make_production_mesh`` (the TPU pod's 16 × 16 grid) is not ported.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch


def _device(d) -> torch.device:
    """``d`` as a ``torch.device``; a bare ``"cuda"`` names the current
    card, so it becomes ``cuda:<current index>`` (where a card exists), as
    the tensors placed there report their device."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None and torch.cuda.is_available():
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A named grid of devices.  Two meshes with the same devices in the
    same layout and the same axis names are equal and hash alike, so a
    mesh rebuilt from the same arguments finds the residencies cached
    under the first (``PackedRuntime.to_device_sharded``)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.empty(np.shape(devices), dtype=object)
        for idx, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            grid[idx] = _device(d)
        if grid.ndim != len(axis_names):
            raise ValueError(f"{grid.ndim}-d device grid for axes "
                             f"{tuple(axis_names)}")
        if grid.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.devices = grid
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str):
        """The device of each index along ``axis`` (the first of the other
        axes, which replicate): where row shard s of a table sharded over
        ``axis`` lives."""
        grid = np.moveaxis(self.devices, self.axis_names.index(axis), 0)
        return [grid[s].flat[0] for s in range(grid.shape[0])]

    def _key(self):
        return (self.devices.shape, tuple(str(d) for d in self.devices.flat),
                self.axis_names)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, "
                f"devices={sorted({str(d) for d in self.devices.flat})})")


def make_host_mesh(data: int = 1, model: int = 1,
                   device: str = "cuda") -> Mesh:
    """A ``(data, model)`` mesh.  ``device="cuda"`` (no index) lays the
    slots, in row-major order, over the visible cards in turn (slot i on
    ``cuda:<i mod count>``): one card a slot when there are enough, every
    slot on the one card of a one-card machine.  A device with an index,
    or ``"cpu"``, fills every slot: ``data`` shards on one device.  A
    CUDA device on a machine without one raises, as the index does."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"make_host_mesh(device={device!r}) but CUDA is not available; "
            "pass device='cpu' for a mesh on the CPU")
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        slots = [torch.device("cuda", i % count)
                 for i in range(data * model)]
        grid = np.empty(data * model, dtype=object)
        grid[:] = slots
        return Mesh(grid.reshape(data, model), ("data", "model"))
    return Mesh(np.full((data, model), _device(dev), dtype=object),
                ("data", "model"))


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The composite data-parallel axis group for this mesh."""
    return (("pod", "data") if "pod" in mesh.axis_names else ("data",))


def axis_size(mesh: Mesh, names) -> int:
    if isinstance(names, str):
        names = (names,)
    out = 1
    for n in names:
        out *= mesh.shape[n]
    return out


__all__ = ["Mesh", "make_host_mesh", "dp_axes", "axis_size"]
