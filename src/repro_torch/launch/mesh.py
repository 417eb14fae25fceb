"""The production meshes, as axis sizes (a function, not a module-level
constant, so importing touches no device).

Counterpart of ``repro/launch/mesh.py``. Single pod: (data=16, model=16),
256 chips; multi-pod: (pod=2, data=16, model=16), 512 chips; the pod axis
folds into data parallelism. A ``ProductionMesh`` is the mapping the
sharding rules read (``distributed/sharding.py``: ``.shape``, axis name to
size, in the axes' order); no device stands behind it. ``step_ctx`` gives
the ``MeshCtx`` a cell's step runs under: the port's ``MeshCtx`` knows
the axes ``data`` and ``model`` only, so ``pod`` folds into its data axis,
the same data-parallel axes ``data_axes`` names.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.distributed.mesh_ctx import MeshCtx


@dataclasses.dataclass(frozen=True)
class ProductionMesh:
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def n_chips(self) -> int:
        return math.prod(self.sizes)

    @property
    def tag(self) -> str:
        return "pod" + "x".join(str(s) for s in self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> ProductionMesh:
    if multi_pod:
        return ProductionMesh(("pod", "data", "model"), (2, 16, 16))
    return ProductionMesh(("data", "model"), (16, 16))


def data_axes(mesh) -> tuple:
    """The data-parallel axes of ``mesh`` (pod folds into them)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def all_axes(mesh) -> tuple:
    return tuple(mesh.axis_names)


def fold_axes(axes):
    """A tuple of ``mesh``'s axis names in the step's ``MeshCtx`` terms:
    ``pod`` and ``data`` become one ``data``; None stays None."""
    if axes is None:
        return None
    out = []
    for a in axes:
        a = "data" if a == "pod" else a
        if a not in out:
            out.append(a)
    return tuple(out)


def step_ctx(mesh, device="meta", **kw) -> MeshCtx:
    """The ``MeshCtx`` of a cell's step on ``mesh``: every model-axis block
    on ``device`` (``meta``: nothing behind it; one card: all its blocks
    on that card), the data axis ``pod · data`` blocks. ``kw``: the
    ``MeshCtx`` fields (``data_axes``, ``seq_axes``, ...) in ``mesh``'s
    axis names, folded by ``fold_axes``."""
    sizes = mesh.shape
    for name in ("data_axes", "seq_axes"):
        if name in kw:
            kw[name] = fold_axes(kw[name])
    return MeshCtx((device,) * sizes["model"], data=sizes.get("pod", 1) * sizes["data"], **kw)
