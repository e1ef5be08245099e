"""The search's data mesh: S shard slots driven from one process.

Counterpart of ``repro.launch.mesh``'s ``make_data_mesh`` and
``describe``.  The reference is single-controller: one process runs
``shard_map`` over S devices, and its tests get S = 8 by forcing XLA host
devices.  The port keeps that design.  A :class:`DataMesh` is an axis name
and S shard devices; a shard is a slot in one process's lists, and a
collective (``repro_torch.core.distributed``) is a plain function over the
per-shard list.  On one card the S shards are S × ``cuda:0``, the analogue
of JAX's forced host devices; on a host with S cards, ``cuda:0..S-1``.

``make_production_mesh``, ``make_test_mesh`` and ``ensure_host_devices``
are XLA-device plumbing for training and the dry run; they come with the
training slice of the port.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A 1-D mesh: ``axis`` and one device per shard."""

    devices: tuple
    axis: str = "data"

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        """``{axis: S}``, as ``jax.sharding.Mesh.shape`` reads."""
        return {self.axis: self.size}

    @property
    def device(self) -> torch.device:
        """Shard 0's device: where replicated values are computed."""
        return self.devices[0]


def make_data_mesh(num_shards: int, device: str | torch.device | None = None) -> DataMesh:
    """A ``("data",)`` mesh of ``num_shards`` shards.  With no ``device``
    the shards go on the card: ``cuda:0..S-1`` when the host has S cards,
    else S × ``cuda:0``; without a card this raises.  ``device="cpu"``
    (or any explicit device) puts every shard there."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    dev = resolve(device)
    if dev.type == "cuda" and device is None and torch.cuda.device_count() >= num_shards:
        devices = tuple(torch.device("cuda", i) for i in range(num_shards))
    else:
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
        devices = (dev,) * num_shards
    return DataMesh(devices=devices)


def describe(mesh: DataMesh) -> str:
    return f"mesh({mesh.size},) axes=('{mesh.axis}',) devices={[str(d) for d in mesh.devices]}"
