"""One embedding table a sparse field, row-split over the model axis.

Counterpart of ``repro/embedding/sharded.py``. ``FieldSpec`` describes a
field (one-hot, or a padded multi-hot bag); ``EmbeddingCollection`` holds
one table a field, initialised N(0, init_std²) from an explicit generator,
and concatenates the fields' lookups. ``partition_specs`` gives each table
the spec ``("model", None)``: its rows (the vocabulary) split over the model
axis, the layout ``distributed/sharding.py`` places.
``weights.load_jax_embedding_collection`` loads the reference's
``{"tables": {...}}`` params.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.embedding.embedding_bag import multihot_lookup
from repro_torch.nn.layers import embedding


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    name: str
    vocab: int
    dim: int
    n_hot: int = 1            # 1: a one-hot field; > 1: a padded multi-hot bag
    mode: str = "sum"


class EmbeddingCollection(nn.Module):
    def __init__(self, fields: Sequence[FieldSpec], init_std: float = 0.01,
                 device: DeviceLike = "cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.fields = tuple(fields)
        self.init_std = init_std
        self.tables = nn.ParameterDict()
        for f in self.fields:
            t = torch.empty((f.vocab, f.dim), device=dev)
            with torch.no_grad():
                nn.init.normal_(t, std=init_std, generator=generator)
            self.tables[f.name] = nn.Parameter(t)

    def apply(self, batch: dict) -> torch.Tensor:
        """batch[f.name]: (B,) ids of a one-hot field, (B, n_hot) of a bag
        (with an optional ``batch[f.name + "_mask"]``) -> (B, total_dim),
        the fields' lookups concatenated in order."""
        outs = []
        for f in self.fields:
            ids, table = batch[f.name], self.tables[f.name]
            if f.n_hot == 1 and ids.dim() == 1:
                outs.append(embedding(ids.long(), table))
            else:
                outs.append(multihot_lookup(table, ids, batch.get(f.name + "_mask"), f.mode))
        return torch.cat(outs, dim=-1)

    forward = apply

    @property
    def total_dim(self) -> int:
        return sum(f.dim for f in self.fields)

    def partition_specs(self, model_axis: str = "model") -> dict:
        """Each table's rows over ``model_axis``: ``{"tables": {name:
        (model_axis, None)}}``."""
        return {"tables": {f.name: (model_axis, None) for f in self.fields}}
