"""Analytical rooflines on the card: the least time the H100 could take
for some work, the largest of its bytes over the memory rate, its
operations over the peak rate and the bytes it moves between cards over
the NVLink rate.

Counterpart of ``repro/distributed/roofline.py``, with two records:

* ``RooflineRecord`` and ``analyze(name, flops, bytes, collective_bytes,
  n_chips)``: one dispatch, what the kernel profiler
  (``serve/profiler.py``) reads and prints;
* ``CellRooflineRecord``: one step of a dry-run cell per chip (the
  reference's ``RooflineRecord`` fields and properties), what
  ``launch/dryrun.py`` writes and ``launch/report.py`` renders.

For the dispatch record: the JAX package
reads flops and bytes from XLA's ``cost_analysis()`` and its collective
bytes from the HLO's collectives; the port has neither, so the caller
hands in the analytical counts of ``kernels/cost.py``, whose collective
bytes are the rows a sharded dispatch sends to a shard on another card and
back. Work is taken as spread evenly over the ``n_chips`` cards of the
dispatch; the collective bytes all cross the caller's card's links. On one
card (every shard on it) the collective term is 0.

For the cell record: the JAX package reads flops, bytes and collectives
from the compiled step; the port compiles nothing, so ``launch/dryrun.py``
hands in counts (model flops spread over the chips, argument and output
bytes, the parameters' collective bytes). ``useful_flops_fraction`` is
None: there is no compiled flop count to divide the model flops by. The
compute term divides by the peak of the cell's compute dtype.

Hardware: NVIDIA H100 SXM data sheet, 3.35 TB/s HBM3, 67 TFLOP/s fp32
outside the tensor cores (the kernels compute in IEEE fp32, no TF32),
989 TFLOP/s dense bf16 on the tensor cores (cells whose compute dtype is
bf16 only), 900 GB/s of NVLink per card, both directions together, and
80 GiB of HBM a card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

HBM_BW = 3.35e12        # bytes/s per card
PEAK_FLOPS = 67e12      # fp32 FLOP/s per card
PEAK_FLOPS_BF16 = 989e12  # dense bf16 FLOP/s per card, tensor cores
LINK_BW = 900e9         # NVLink bytes/s per card, both directions
HBM_BYTES = 80 * 2**30  # device memory per card

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute")


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


def peak_flops(compute_dtype: str) -> float:
    """The card's peak for a step computing in ``compute_dtype``."""
    return PEAK_FLOPS_BF16 if compute_dtype == "bfloat16" else PEAK_FLOPS


@dataclasses.dataclass
class CellRooflineRecord:
    """One step of a cell, per chip, in seconds: compute, memory and
    collective terms (the reference's ``RooflineRecord``)."""
    name: str
    n_chips: int
    flops_per_chip: float
    hbm_bytes_per_chip: float
    collective_bytes_per_chip: float
    collective_breakdown: dict
    peak_memory_per_chip: float
    model_flops: Optional[float] = None
    peak_flops: float = PEAK_FLOPS

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_chip / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def roofline_time(self) -> float:
        """Lower bound on the step's time (the terms overlap perfectly)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> Optional[float]:
        """None: no compiled flop count to hold the model flops against."""
        return None

    @property
    def roofline_fraction(self) -> Optional[float]:
        """The model flops' time at peak over the roofline time."""
        if not self.model_flops:
            return None
        ideal = self.model_flops / (self.n_chips * self.peak_flops)
        return ideal / max(self.roofline_time, 1e-30)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "n_chips": self.n_chips,
            "flops_per_chip": self.flops_per_chip,
            "hbm_bytes_per_chip": self.hbm_bytes_per_chip,
            "collective_bytes_per_chip": self.collective_bytes_per_chip,
            "collective_breakdown": self.collective_breakdown,
            "peak_memory_per_chip": self.peak_memory_per_chip,
            "model_flops": self.model_flops,
            "peak_flops": self.peak_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
        }
