"""Elastic scaling: restore any checkpoint onto any mesh.

Counterpart of ``repro/train/elastic.py``. A checkpoint holds whole
logical arrays, whatever mesh wrote it, so moving to another mesh is:
build the new ``MeshCtx``, derive each parameter's spec from the sharding
rules (``distributed/sharding.py``), and place each leaf as its blocks
during restore (``train/checkpoint.restore``'s ``sharding_fn``). It works
across data and model degrees and device counts: the restart after losing
or gaining cards.

``scale_batch_for_mesh`` keeps the global batch fixed across meshes, so the
optimizer's trajectory does not change (the data stream is deterministic
in the global step, not in the device count).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

from repro_torch.distributed.mesh_ctx import MeshCtx
from repro_torch.distributed.sharding import Placement
from repro_torch.train import checkpoint as ckpt_lib


def sharding_fn_from_rules(mesh: MeshCtx, rules: Callable[[str, tuple], Optional[tuple]]
                           ) -> Callable[[str, tuple], Placement]:
    """(path, shape) -> ``Placement(mesh, rules(path, shape))``; a rule's
    None is () (replicated)."""
    def fn(path: str, shape: tuple) -> Placement:
        spec = rules(path, shape)
        return Placement(mesh, () if spec is None else tuple(spec))
    return fn


def restore_on_mesh(ckpt_dir: str, template: Any, mesh: MeshCtx,
                    rules: Callable[[str, tuple], Optional[tuple]], step: Optional[int] = None):
    """(state, step): the checkpoint restored into ``template`` with every
    tensor and array leaf placed on ``mesh`` by ``rules``."""
    return ckpt_lib.restore(ckpt_dir, template, step,
                            sharding_fn=sharding_fn_from_rules(mesh, rules))


def scale_batch_for_mesh(global_batch: int, mesh, data_axis: str = "data") -> int:
    """The batch of one data shard of ``mesh`` (a ``MeshCtx``: its
    ``data``), the global batch held fixed; an AssertionError where the
    data axis does not divide it, as the reference's assert."""
    dp = mesh.shape[data_axis]
    if global_batch % dp:
        raise AssertionError((global_batch, dp))
    return global_batch // dp
