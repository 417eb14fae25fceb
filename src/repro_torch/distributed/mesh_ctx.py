"""MeshCtx: the devices a sharded BSE table store lives on.

Counterpart of ``repro/distributed/mesh_ctx.py::MeshCtx`` together with
``repro/distributed/sharding.py::table_store_spec``, cut to what the
sharded store needs. The JAX package drives its mesh from one process
(``shard_map`` under one controller) and row-shards the ``(S, C, G, U,
d)`` store over the mesh's model axis. The port does the same from one
process: the model axis is an ordered tuple of ``torch.device``s, one per
shard, and shard ``k``'s ``(C, G, U, d)`` block lives on ``devices[k]``.
Devices may repeat: ``(cuda:0,) * 8`` runs the whole sharded path on one
card, ``(cpu,) * 8`` on the host, as the JAX tests fake eight host devices.
A CUDA device named without an index is the current one.
The data axis only records its size: the store is replicated over it, and
one process holds one copy of each shard.

``owned`` is the masking rule every sharded operation shares: a handle
``(shard, local)`` belongs to one shard, and the other shards see its row
as foreign (mask 0, slot clamped to 0), as the reference's ``shard_map``
bodies do.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Union

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MeshCtx:
    devices: tuple          # the model axis: shard k's device
    data: int = 1           # the data axis' size (replicas of every shard)

    def __post_init__(self):
        devices = tuple(canonical(d) for d in self.devices)
        if not devices:
            raise ValueError("a mesh needs at least one model-axis device")
        if self.data < 1:
            raise ValueError(f"the data axis needs a size >= 1, got {self.data}")
        object.__setattr__(self, "devices", devices)

    @staticmethod
    def wrap(m: Union["MeshCtx", Sequence, None]) -> "MeshCtx | None":
        """A ``MeshCtx``, or one over a sequence of devices; None stays None."""
        if m is None or isinstance(m, MeshCtx):
            return m
        return MeshCtx(tuple(m))

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.n_shards}

    @property
    def n_devices(self) -> int:
        """Distinct devices the shards occupy (one card: 1)."""
        return len(set(self.devices))


def canonical(device) -> torch.device:
    """``device`` as a ``torch.device``, a CUDA device without an index as
    the current one, so that two names of one card compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def place(n_shards: int, pool: Sequence) -> tuple:
    """``n_shards`` shards over the devices of ``pool``, round-robin:
    shard k on ``pool[k % len(pool)]``."""
    if n_shards < 1 or not pool:
        raise ValueError(f"cannot place {n_shards} shards over {len(pool)} devices")
    return tuple(torch.device(pool[k % len(pool)]) for k in range(n_shards))


def owned(handles: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """For (B, 2) ``[shard, local]`` handles and shard ``k``: which rows
    shard k owns (B,) bool, and the local slot of each row with the foreign
    ones clamped to 0 (B,) int32."""
    mine = handles[:, 0] == k
    return mine, np.where(mine, handles[:, 1], 0).astype(np.int32)
