"""The analytical roofline of one dispatch on the card: the least time the
H100 could take for a kernel's work, the larger of its bytes over the
memory rate and its operations over the fp32 peak.

Counterpart of ``repro/distributed/roofline.py``, cut to what the kernel
profiler (``serve/profiler.py``) needs: ``RooflineRecord`` and
``analyze(name, flops, bytes)``. The JAX package reads flops and bytes
from XLA's ``cost_analysis()`` and adds a collective term from the HLO;
the port has neither, so the caller hands in the analytical counts of
``kernels/cost.py``, and the profiled dispatches run on one card with no
collective.

Hardware: NVIDIA H100 SXM data sheet, 3.35 TB/s HBM3 and 67 TFLOP/s fp32
outside the tensor cores (the kernels compute in IEEE fp32, no TF32).
"""
from __future__ import annotations

import dataclasses

HBM_BW = 3.35e12        # bytes/s per card
PEAK_FLOPS = 67e12      # fp32 FLOP/s per card


@dataclasses.dataclass
class RooflineRecord:
    name: str
    flops: float
    hbm_bytes: float

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def bottleneck(self) -> str:
        return "compute" if self.t_compute > self.t_memory else "memory"

    @property
    def roofline_time(self) -> float:
        """Lower bound on the dispatch's time (the terms overlap perfectly)."""
        return max(self.t_compute, self.t_memory)


def analyze(name: str, flops: float, bytes: float) -> RooflineRecord:
    """The roofline of a dispatch that does ``flops`` fp32 operations and
    moves ``bytes`` over HBM."""
    return RooflineRecord(name=name, flops=float(flops), hbm_bytes=float(bytes))
