"""MeshCtx: the devices a sharded run lives on, and how it maps onto the
mesh's ``data`` and ``model`` axes.

Counterpart of ``repro/distributed/mesh_ctx.py::MeshCtx``. The JAX
package drives its mesh from one process (``shard_map`` and GSPMD under one
controller) and row-shards the ``(S, C, G, U, d)`` store over the mesh's
model axis (``distributed/sharding.py::table_store_spec``). The port does
the same from one process: the model axis is an ordered tuple of
``torch.device``s, one per shard, and shard ``k``'s ``(C, G, U, d)`` block
lives on ``devices[k]``. Devices may repeat: ``(cuda:0,) * 8`` runs the
whole sharded path on one card, ``(cpu,) * 8`` on the host, as the JAX
tests fake eight host devices. A CUDA device named without an index is the
current one. The data axis only records its size: the store is replicated
over it, and one process holds one copy of each shard.

The model code's sharded paths read the reference's fields: ``data_axes``
(the axes a batch is split over; None: tokens replicated, as in decode),
``model_axis`` (the axis the experts are split over, into ``ep`` groups),
``seq_axes`` (the axes a KV cache's sequence is split over in split-KV
decode), ``dp``, ``ep`` and ``for_decode``. A tuple of axis names splits an
array into ``prod(axis sizes)`` blocks in row-major order over the axes
(the reference's ``_combined_axis_index``: over ``("data", "model")``,
block ``data_idx * model + model_idx``); ``axis_devices`` gives block k the
device ``devices[k % n_shards]``, as ``place`` does, which puts every block
of one model index on that index's device. Partial results are summed in
block order on the first block's device, so a ``psum`` gives the same bits
on every run.

A training step's fields: ``act_seq_shard`` (the residual stream split B
over the data axes and T over the model axis between blocks,
``constrain_residual``) and ``manual_tp`` (the dense FFN as the Megatron
column/row split of ``distributed/manual_tp.py``). The reference's
``constrain`` is GSPMD's ``with_sharding_constraint``: a placement hint
that changes no value. The port computes on whole tensors, so
``constrain`` and ``constrain_residual`` check the spec against the mesh
and the array and return the array itself. Under ``jit``, where the
reference's model runs, a spec whose axes do not divide a dimension (a
vocab of 130 over 4) passes, GSPMD padding the blocks; so it passes here.
Where parameters live as blocks, ``distributed/sharding.py`` places them.

``owned`` is the masking rule every sharded operation shares: a handle
``(shard, local)`` belongs to one shard, and the other shards see its row
as foreign (mask 0, slot clamped to 0), as the reference's ``shard_map``
bodies do.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MeshCtx:
    devices: tuple          # the model axis: shard k's device
    data: int = 1           # the data axis' size (replicas of every shard)
    data_axes: Optional[Tuple[str, ...]] = ("data",)   # None: tokens replicated
    model_axis: str = "model"
    seq_axes: Optional[Tuple[str, ...]] = None         # split-KV decode's cache axes
    act_seq_shard: bool = False     # residual: B over data_axes, T over model_axis
    manual_tp: bool = False         # the dense FFN through manual_tp_gated_ffn

    def __post_init__(self):
        devices = tuple(canonical(d) for d in self.devices)
        if not devices:
            raise ValueError("a mesh needs at least one model-axis device")
        if self.data < 1:
            raise ValueError(f"the data axis needs a size >= 1, got {self.data}")
        object.__setattr__(self, "devices", devices)
        for axes in (self.data_axes or (), (self.model_axis,), self.seq_axes or ()):
            for a in axes:
                if a not in ("data", "model"):
                    raise ValueError(f"unknown mesh axis {a!r}: the axes are 'data' and 'model'")

    def constrain(self, x: torch.Tensor, *spec) -> torch.Tensor:
        """The reference's ``with_sharding_constraint(x, P(*spec))``: ``x``
        itself (a placement hint changes no value). Raises where the spec
        names an axis the mesh lacks or has more entries than ``x`` has
        dimensions, as ``PartitionSpec`` does; an axis that does not divide
        its dimension passes, as under ``jit``."""
        if len(spec) > x.dim():
            raise ValueError(f"a spec of {len(spec)} entries for an array of rank {x.dim()}")
        for entry in spec:
            for a in (entry,) if isinstance(entry, str) else entry or ():
                if a not in self.shape:
                    raise ValueError(f"unknown mesh axis {a!r}: the axes are 'data' and 'model'")
        return x

    def constrain_residual(self, x: torch.Tensor) -> torch.Tensor:
        """A (B, T, d) residual: B over the data axes, T over the model axis,
        where ``act_seq_shard`` is on and T > 1; ``x`` itself."""
        if not self.act_seq_shard or x.shape[1] == 1:
            return x
        return self.constrain(x, self.data_axes, self.model_axis, None)

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

    def for_decode(self) -> "MeshCtx":
        """This mesh with tokens replicated (``data_axes`` None)."""
        return dataclasses.replace(self, data_axes=None)

    def axis_size(self, axes) -> int:
        """The number of blocks a tuple of axis names splits into (None or
        (): 1)."""
        return math.prod(self.shape[a] for a in axes or ())

    @property
    def dp(self) -> int:
        return self.axis_size(self.data_axes)

    @property
    def ep(self) -> int:
        return self.shape[self.model_axis]

    def axis_devices(self, axes) -> tuple:
        """The device of each block of the row-major split over ``axes``:
        block k on ``devices[k % n_shards]``."""
        return tuple(self.devices[k % self.n_shards] for k in range(self.axis_size(axes)))


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


def block_size(n: int, n_blocks: int, what: str) -> int:
    """``n / n_blocks``; raises where ``n_blocks`` does not divide ``n``, as
    the reference's ``shard_map`` does for an axis it splits."""
    if n % n_blocks:
        raise ValueError(f"{what} of {n} does not split into {n_blocks} equal blocks")
    return n // n_blocks


def psum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of per-block partials in block order, on the first block's
    device: the reference's ``psum``, with the same bits on every run."""
    out = parts[0]
    for part in parts[1:]:
        out = out + part.to(out.device)
    return out
