"""The analytical roofline of one dispatch on the card: the least time the
H100 could take for a kernel's work, the largest of its bytes over the
memory rate, its operations over the fp32 peak and the bytes it moves
between cards over the NVLink rate.

Counterpart of ``repro/distributed/roofline.py``, cut to what the kernel
profiler (``serve/profiler.py``) needs: ``RooflineRecord`` and
``analyze(name, flops, bytes, collective_bytes, n_chips)``. The JAX package
reads flops and bytes from XLA's ``cost_analysis()`` and its collective
bytes from the HLO's collectives; the port has neither, so the caller
hands in the analytical counts of ``kernels/cost.py``, whose collective
bytes are the rows a sharded dispatch sends to a shard on another card and
back. Work is taken as spread evenly over the ``n_chips`` cards of the
dispatch; the collective bytes all cross the caller's card's links. On one
card (every shard on it) the collective term is 0.

Hardware: NVIDIA H100 SXM data sheet, 3.35 TB/s HBM3, 67 TFLOP/s fp32
outside the tensor cores (the kernels compute in IEEE fp32, no TF32) and
900 GB/s of NVLink per card, both directions together.
"""
from __future__ import annotations

import dataclasses

HBM_BW = 3.35e12        # bytes/s per card
PEAK_FLOPS = 67e12      # fp32 FLOP/s per card
LINK_BW = 900e9         # NVLink bytes/s per card, both directions


@dataclasses.dataclass
class RooflineRecord:
    name: str
    flops: float
    hbm_bytes: float
    collective_bytes: float = 0.0
    n_chips: int = 1

    @property
    def t_compute(self) -> float:
        return self.flops / (self.n_chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.n_chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        if self.t_collective > max(self.t_compute, self.t_memory):
            return "collective"
        return "compute" if self.t_compute > self.t_memory else "memory"

    @property
    def roofline_time(self) -> float:
        """Lower bound on the dispatch's time (the terms overlap perfectly)."""
        return max(self.t_compute, self.t_memory, self.t_collective)


def analyze(name: str, flops: float, bytes: float, collective_bytes: float = 0.0,
            n_chips: int = 1) -> RooflineRecord:
    """The roofline of a dispatch that does ``flops`` fp32 operations and
    moves ``bytes`` over HBM on ``n_chips`` cards, and ``collective_bytes``
    between them."""
    return RooflineRecord(name=name, flops=float(flops), hbm_bytes=float(bytes),
                          collective_bytes=float(collective_bytes), n_chips=n_chips)
