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
``attend``        query ∘ encode (the training forward)        ``bse_encode`` +
                                                               ``sdim_query``
``serve``         §4.4 inline serving: encode + query of raw    ``bse_serve``
                  histories in one launch, the table never
                  written to device memory
``serve_fused``   §4.4 decoupled serving: gather rows by slot   ``sdim_fused_serve``
                  out of the (N, G, U, d) store, dequantize,
                  query — one launch
``update``        §4.4 real-time ingest: fold event deltas     ``sdim_update``
                  into store rows by slot, IN PLACE
================  ===========================================  ======================

The sharded entry points take the per-shard blocks of a
``ShardedTableStore`` (``serve/table_store.py``) and (B, 2) ``[shard,
local]`` handles, and launch one kernel per shard, as the reference's
``shard_map`` bodies run one per device:

=======================  ============================================  ===================
``update_sharded``       each shard folds the whole event batch into   ``sdim_update``
                         its block; foreign rows get mask 0 and slot   × S
                         0, so they write nothing
``serve_fused_sharded``  each shard serves the whole batch, present 0  ``sdim_fused_serve``
                         and slot 0 for foreign users (zero            × S
                         interest); the sum over the shards, on the
                         candidates' device, is the batch
``serve_sharded``        the batch padded to a multiple of S and       ``bse_serve`` × S
                         split over the shards; the padding cut off
=======================  ============================================  ===================

``encode`` and ``query`` are differentiable (``attend`` is the training
forward): their wrappers record an autograd Function whose backward is a
CUDA kernel of its own on the card (``bse_encode_backward``,
``sdim_query_backward``) and its closed-form plain version on the CPU. The
gradient reaches the behaviors; signatures are comparisons, so the
candidates and R get none, as in the JAX package. ``serve``,
``serve_fused`` and ``update`` serve and ingest only: on CUDA their
wrappers refuse to run where autograd would record them.

Hash families: ``dense`` (plain GEMM SimHash, paper-faithful) | ``srht``
(subsampled randomized Hadamard transform). The SRHT family is densified
once at construction (``SRHTHashes.dense_matrix``), so both feed the
kernels one dense (m, d) operand.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import simhash
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.mesh_ctx import MeshCtx, owned
from repro_torch.kernels.sdim_bucket.sdim_bucket import bse_encode
from repro_torch.kernels.sdim_fused_serve.sdim_fused_serve import sdim_fused_serve
from repro_torch.kernels.sdim_query.sdim_query import sdim_query
from repro_torch.kernels.sdim_serve.sdim_serve import bse_serve
from repro_torch.kernels.sdim_update.sdim_update import sdim_update


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    m: int = 48               # hash functions (paper: 48 online)
    tau: int = 3              # signature width (paper: 3 online)
    d: int = 128              # behavior embedding dim
    family: str = "dense"     # "dense" | "srht"
    hash_seed: int = 1234

    @property
    def n_groups(self) -> int:
        assert self.m % self.tau == 0, (self.m, self.tau)
        return self.m // self.tau

    @property
    def n_buckets(self) -> int:
        return 1 << self.tau


FAMILIES = ("dense", "srht")


def make_hash_family(cfg: EngineConfig, device: torch.device) -> torch.Tensor:
    """The (m, d) projection operand of ``cfg.family``, from a CPU generator
    seeded with ``hash_seed`` (so every device gets the same R)."""
    gen = torch.Generator().manual_seed(cfg.hash_seed)
    if cfg.family == "dense":
        R = simhash.make_hashes(gen, cfg.m, cfg.d)
    elif cfg.family == "srht":
        R = simhash.srht_hashes(gen, cfg.m, cfg.d).dense_matrix()
    else:
        raise ValueError(f"unknown hash family: {cfg.family!r} (have {FAMILIES})")
    return R.to(device)


def _host_slots(slots, n_rows: int, device: torch.device) -> torch.Tensor:
    """Slots from the host, range-checked there, as int32 on ``device``."""
    s = np.asarray(slots.cpu() if isinstance(slots, torch.Tensor) else slots,
                   np.int64).reshape(-1)
    if s.size and (s.min() < 0 or s.max() >= n_rows):
        raise IndexError(f"slots outside [0, {n_rows}): {s.min()}..{s.max()}")
    return torch.as_tensor(s, dtype=torch.int32, device=device)


def _host_handles(slots, blocks, mesh) -> torch.Tensor:
    """(B, 2) ``[shard, local]`` handles from the host, range-checked
    against ``blocks`` (one per shard of ``mesh``), as an int64 CPU tensor."""
    n_shards = MeshCtx.wrap(mesh).n_shards
    if len(blocks) != n_shards:
        raise ValueError(f"{len(blocks)} blocks for a mesh of {n_shards} shards")
    h = np.asarray(slots.cpu() if isinstance(slots, torch.Tensor) else slots,
                   np.int64).reshape(-1, 2)
    rows = blocks[0].shape[0]
    if h.size and (h[:, 0].min() < 0 or h[:, 0].max() >= n_shards
                   or h[:, 1].min() < 0 or h[:, 1].max() >= rows):
        raise IndexError(f"handles outside [0, {n_shards}) x [0, {rows})")
    return torch.from_numpy(h)


def shard_update_args(k: int, blocks, handles: torch.Tensor, events: torch.Tensor,
                      mask: torch.Tensor, R: torch.Tensor) -> tuple:
    """The arguments shard ``k``'s ``sdim_update`` launch of
    ``update_sharded`` takes, on its block's device: its block, the local
    slots with foreign rows clamped to 0, the events, the mask with foreign
    rows zeroed, R."""
    block = blocks[k]
    dev = block.device
    mine, local = owned(handles.numpy(), k)
    mine_t = torch.as_tensor(mine, dtype=mask.dtype, device=mask.device)
    return (block, torch.as_tensor(local, device=dev), events.to(dev),
            (mask * mine_t[:, None]).to(dev), R.to(dev))


def shard_serve_fused_args(k: int, blocks, handles: torch.Tensor, q: torch.Tensor,
                           R: torch.Tensor, scales=None,
                           present: Optional[torch.Tensor] = None) -> tuple:
    """(args, kwargs) of shard ``k``'s ``sdim_fused_serve`` launch of
    ``serve_fused_sharded``, on its block's device: foreign users get slot
    0 and present 0 (``present``: a (B,) bool CPU tensor)."""
    block = blocks[k]
    dev = block.device
    mine, local = owned(handles.numpy(), k)
    here = mine if present is None else mine & present.numpy()
    return ((block, torch.as_tensor(local, device=dev), q.to(dev), R.to(dev)),
            dict(scales=None if scales is None else scales[k],
                 present=torch.as_tensor(here.astype(np.float32), device=dev)))


def _update_sharded(blocks, handles, events, mask, R, *, tau):
    for k in range(len(blocks)):
        sdim_update(*shard_update_args(k, blocks, handles, events, mask, R), tau)
    return blocks


def _serve_fused_sharded(blocks, handles, q, R, *, tau, scales=None, present=None):
    out = None
    for k in range(len(blocks)):
        args, kw = shard_serve_fused_args(k, blocks, handles, q, R, scales, present)
        part = sdim_fused_serve(*args, tau, **kw).to(q.device)
        out = part if out is None else out + part       # one shard owns each row
    return out


def serve_shards(B: int, n_shards: int) -> list[tuple[int, int]]:
    """The row range [lo, hi) of the (padded) batch each shard serves in
    ``serve_sharded``: B padded to a multiple of ``n_shards``, split evenly."""
    per = -(-B // n_shards)
    return [(k * per, (k + 1) * per) for k in range(n_shards)]


def _rows(t: torch.Tensor, lo: int, hi: int, dev: torch.device) -> torch.Tensor:
    """Rows [lo, hi) of ``t`` on ``dev``, starting on a 16-byte boundary
    (the kernels stage rows 16 bytes at a time)."""
    part = t[lo:hi].to(dev)
    return part if part.data_ptr() % 16 == 0 else part.clone()


def _serve_sharded(q, seq, mask, R, *, tau, devices):
    parts = []
    for dev, (lo, hi) in zip(devices, serve_shards(q.shape[0], len(devices))):
        parts.append(bse_serve(_rows(q, lo, hi, dev), _rows(seq, lo, hi, dev),
                               _rows(mask, lo, hi, dev), R.to(dev), tau).to(q.device))
    return torch.cat(parts)


class SDIMEngine:
    """Owns the hash family and dispatches encode/query/attend/serve/
    serve_fused/update.

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

    def attend(self, q: torch.Tensor, seq: torch.Tensor,
               mask: Optional[torch.Tensor] = None,
               R: Optional[torch.Tensor] = None) -> torch.Tensor:
        """End-to-end SDIM attention (training graph): query ∘ encode, in
        seq's dtype."""
        table = self.encode(seq, mask, R)
        return self.query(q, table, R).to(seq.dtype)

    def serve(self, q: torch.Tensor, seq: torch.Tensor,
              mask: Optional[torch.Tensor] = None,
              R: Optional[torch.Tensor] = None) -> torch.Tensor:
        """§4.4 inline serving: candidates (B, C, d) against histories
        (B, L, d) [+ mask (B, L)] in ONE launch; the bucket table never
        reaches device memory. Returns (B, C, d) in seq's dtype."""
        if mask is None:
            mask = torch.ones(seq.shape[:2], dtype=torch.float32, device=seq.device)
        out = self._dispatch("serve", bse_serve,
                             (q.float().contiguous(), seq.contiguous(),
                              mask.float().contiguous(), self._R(R)),
                             dict(tau=self.cfg.tau))
        return out.to(seq.dtype)

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

    # ------------------------------------------------------------------
    # sharded entry points (ShardedTableStore; one launch per shard)
    # ------------------------------------------------------------------
    def update_sharded(self, blocks, slots, events: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       R: Optional[torch.Tensor] = None, *, mesh) -> tuple:
        """``update`` against the fp32 blocks of a sharded store (one per
        shard of ``mesh``, a ``MeshCtx`` or a device list), IN PLACE:
        ``slots`` are (B, 2) ``[shard, local]`` handles; each shard's
        ``sdim_update`` folds the whole batch with foreign rows masked out,
        so it writes only the rows it owns. Semantics (duplicate
        accumulation, fp32 sums) are ``update``'s. Returns ``blocks``."""
        if mask is None:
            mask = torch.ones(events.shape[:2], dtype=torch.float32, device=events.device)
        return self._dispatch(
            "update_sharded", _update_sharded,
            (tuple(blocks), _host_handles(slots, blocks, mesh), events.contiguous(),
             mask.float().contiguous(), self._R(R)),
            dict(tau=self.cfg.tau))

    def serve_fused_sharded(self, blocks, slots, q: torch.Tensor, present=None,
                            scales=None, R: Optional[torch.Tensor] = None, *,
                            mesh) -> torch.Tensor:
        """``serve_fused`` off the blocks (and, int8/fp8, scale blocks) of a
        sharded store: ``slots`` are (B, 2) ``[shard, local]`` handles; each
        shard's ``sdim_fused_serve`` serves the whole batch with ``present``
        0 for the users it does not own, and the sum over the shards on
        q's device is the batch. Semantics match ``serve_fused``. Returns
        (B, C, d) fp32."""
        handles = _host_handles(slots, blocks, mesh)
        present = torch.as_tensor(np.ones(handles.shape[0], bool) if present is None
                                  else np.asarray(present, bool))
        return self._dispatch(
            "serve_fused_sharded", _serve_fused_sharded,
            (tuple(blocks), handles, q.float().contiguous(), self._R(R)),
            dict(tau=self.cfg.tau, scales=None if scales is None else tuple(scales),
                 present=present))

    def serve_sharded(self, q: torch.Tensor, seq: torch.Tensor,
                      mask: Optional[torch.Tensor] = None,
                      R: Optional[torch.Tensor] = None, *, mesh) -> torch.Tensor:
        """``serve`` with the request batch split over the mesh's model
        axis: B is padded to a multiple of S, shard k serves rows
        ``serve_shards(B, S)[k]`` on its device in one ``bse_serve``, and
        the padded rows are cut off. Returns (B, C, d) in seq's dtype."""
        devices = MeshCtx.wrap(mesh).devices
        B = q.shape[0]
        if mask is None:
            mask = torch.ones(seq.shape[:2], dtype=torch.float32, device=seq.device)
        pad = -B % len(devices)
        qf, mf = q.float(), mask.float()
        if pad:
            zeros = lambda x: x.new_zeros((pad, *x.shape[1:]))
            qf, seq, mf = torch.cat([qf, zeros(qf)]), torch.cat([seq, zeros(seq)]), \
                torch.cat([mf, zeros(mf)])
        out = self._dispatch("serve_sharded", _serve_sharded,
                             (qf.contiguous(), seq.contiguous(), mf.contiguous(), self._R(R)),
                             dict(tau=self.cfg.tau, devices=devices))
        return out[:B].to(seq.dtype)
