"""SDIMEngine — the SDIM compute layer of the port.

Counterpart of ``repro/core/engine.py``. Every consumer (the CTR model's
interest branch, the BSE server, the CTR server) reaches hash → bucket →
gather through this object. Each operation calls one kernel wrapper; the
wrapper launches the hand-written CUDA kernel for CUDA tensors and runs its
plain PyTorch version for CPU tensors, so the engine has no backend flag:
where the data lies decides, and CUDA data never falls back to the plain
version.

================  ===========================================  ======================
operation         what it computes (paper §3.3 / §4)           kernel
================  ===========================================  ======================
``encode``        Eq. 8/11: signatures of every behavior, then  ``bse_encode``
                  the per-group bucket sums (the BSE table)
``query``         Eq. 9/11/12: hash the candidate, read its     ``sdim_query``
                  bucket in every group, ℓ2-normalize, mean
``serve_fused``   §4.4 decoupled serving: gather rows by slot   ``sdim_fused_serve``
                  out of the (N, G, U, d) store, dequantize,
                  query — one launch
``update``        §4.4 real-time ingest: fold event deltas     ``sdim_update``
                  into store rows by slot, IN PLACE
================  ===========================================  ======================

``serve``/``attend`` (inline serving), the sharded entry points and the
SRHT family are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import simhash
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.sdim_bucket.sdim_bucket import bse_encode
from repro_torch.kernels.sdim_fused_serve.sdim_fused_serve import sdim_fused_serve
from repro_torch.kernels.sdim_query.sdim_query import sdim_query
from repro_torch.kernels.sdim_update.sdim_update import sdim_update


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    m: int = 48               # hash functions (paper: 48 online)
    tau: int = 3              # signature width (paper: 3 online)
    d: int = 128              # behavior embedding dim
    hash_seed: int = 1234

    @property
    def n_groups(self) -> int:
        assert self.m % self.tau == 0, (self.m, self.tau)
        return self.m // self.tau

    @property
    def n_buckets(self) -> int:
        return 1 << self.tau


def make_hash_family(cfg: EngineConfig, device: torch.device) -> torch.Tensor:
    """The dense (m, d) projection operand, from a CPU generator seeded
    with ``hash_seed`` (so every device gets the same R)."""
    gen = torch.Generator().manual_seed(cfg.hash_seed)
    return simhash.make_hashes(gen, cfg.m, cfg.d).to(device)


def _host_slots(slots, n_rows: int, device: torch.device) -> torch.Tensor:
    """Slots from the host, range-checked there, as int32 on ``device``."""
    s = np.asarray(slots.cpu() if isinstance(slots, torch.Tensor) else slots,
                   np.int64).reshape(-1)
    if s.size and (s.min() < 0 or s.max() >= n_rows):
        raise IndexError(f"slots outside [0, {n_rows}): {s.min()}..{s.max()}")
    return torch.as_tensor(s, dtype=torch.int32, device=device)


class SDIMEngine:
    """Owns the hash family and dispatches encode/query/serve_fused/update.

    ``R`` may be passed per call (the CTR model keeps it as a buffer); when
    omitted the engine's own family, made from ``cfg.hash_seed``, is used.
    """

    def __init__(self, cfg: EngineConfig, R: Optional[torch.Tensor] = None,
                 device: DeviceLike = "cuda"):
        cfg.n_groups  # fail fast on m % tau != 0
        self.cfg = cfg
        self.device = resolve_device(device)
        self.R = make_hash_family(cfg, self.device) if R is None else R
        assert tuple(self.R.shape) == (cfg.m, cfg.d), (tuple(self.R.shape), cfg)
        # measurement seam: a profiler with profile(kernel, fn, args, kwargs)
        # attaches here; None costs one branch per dispatch
        self.profiler = None

    def _R(self, R: Optional[torch.Tensor]) -> torch.Tensor:
        return self.R if R is None else R

    def _dispatch(self, kernel: str, fn, args: tuple, kwargs: dict):
        """Every kernel call funnels through here so an attached profiler
        sees all of them; without one it is a plain call."""
        if self.profiler is None:
            return fn(*args, **kwargs)
        return self.profiler.profile(kernel, fn, args, kwargs)

    # ------------------------------------------------------------------
    def encode(self, seq: torch.Tensor, mask: Optional[torch.Tensor] = None,
               R: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Behaviors (B, L, d) [+ mask (B, L)] -> bucket table (B, G, U, d)."""
        if mask is None:
            mask = torch.ones(seq.shape[:2], dtype=torch.float32, device=seq.device)
        return self._dispatch("encode", bse_encode,
                              (seq, mask.float().contiguous(), self._R(R)),
                              dict(tau=self.cfg.tau))

    def query(self, q: torch.Tensor, table: torch.Tensor,
              R: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Candidates (B, d)/(B, C, d) x table (B, G, U, d) -> interest with
        q's leading shape + (d,), fp32."""
        single = q.ndim == 2
        qc = (q[:, None, :] if single else q).float().contiguous()
        out = self._dispatch("query", sdim_query,
                             (qc, table.contiguous(), self._R(R)),
                             dict(tau=self.cfg.tau))
        return out[:, 0] if single else out

    def serve_fused(self, store: torch.Tensor, slots, q: torch.Tensor,
                    present=None, scales: Optional[torch.Tensor] = None,
                    R: Optional[torch.Tensor] = None) -> torch.Tensor:
        """§4.4 decoupled serving in ONE launch: gather rows ``slots`` (B,)
        out of the (N, G, U, d) store, dequantize (``scales`` per row for
        int8 stores) and score candidates (B, C, d). ``present`` (B,) zeroes
        absent users' interest. Returns (B, C, d) fp32."""
        dev = store.device
        slots_t = _host_slots(slots, store.shape[0], dev)
        present_t = (None if present is None else
                     torch.as_tensor(np.asarray(present, np.float32), device=dev))
        return self._dispatch(
            "serve_fused", sdim_fused_serve,
            (store, slots_t, q.float().contiguous(), self._R(R)),
            dict(tau=self.cfg.tau, scales=scales, present=present_t))

    def update(self, store: torch.Tensor, slots, events: torch.Tensor,
               mask: Optional[torch.Tensor] = None,
               R: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Fold events (B, E, d) [+ mask (B, E)] into rows ``slots`` (B,) of
        the fp32 store (N, G, U, d) IN PLACE — one launch for the batch;
        duplicate slots accumulate. Returns ``store`` itself."""
        if mask is None:
            mask = torch.ones(events.shape[:2], dtype=torch.float32,
                              device=events.device)
        slots_t = _host_slots(slots, store.shape[0], store.device)
        return self._dispatch(
            "update", sdim_update,
            (store, slots_t, events.contiguous(), mask.float().contiguous(),
             self._R(R)),
            dict(tau=self.cfg.tau))
