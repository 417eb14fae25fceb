"""Long-term user-interest module (paper: SDIM is architecture-free, §4.4).

Counterpart of ``repro/core/interest.py``, all nine kinds:

=================  ===========================================  ===========================
kind               what the long branch computes                kernels (forward, backward)
=================  ===========================================  ===========================
``sdim``           the paper: SimHash buckets, Eq. 12           ``bse_encode``, ``sdim_query``
``sdim_expected``  Eq. 14's closed-form expectation (m/τ → ∞)   none
``target``         exact target attention over the history      ``target_attention_flash``
                   (DIN long-sequence)
``din_mlp``        DIN's activation unit (MLP weights, no        none
                   softmax)
``avg``            masked mean pooling                          none
``sim_hard``       category match, most recent k, target attn.  ``target_attention_flash``
``eta``            top k by SimHash Hamming similarity, t. a.   ``target_attention_flash``
``ubr4ctr``        top k by a learned projection, target attn.  ``target_attention_flash``
``none``           zeros (the model drops the branch)           none
=================  ===========================================  ===========================

The hash matrix R of ``sdim`` (family ``dense`` or ``srht``) and of
``eta`` is a non-trainable buffer (checkpointed with the model, excluded
from training). Every kind trains: gradients reach the behaviors (and the
candidates, through attention) through the kernels' autograd Functions.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.core import retrieval, sdim
from repro_torch.core.engine import EngineConfig, SDIMEngine, make_hash_family
from repro_torch.core.target_attention import DinActivationUnit
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.target_attn.target_attn import target_attention_flash

INTEREST_KINDS = ("sdim", "sdim_expected", "target", "din_mlp", "avg",
                  "sim_hard", "eta", "ubr4ctr", "none")


@dataclasses.dataclass(frozen=True)
class InterestConfig:
    kind: str = "sdim"
    d: int = 32
    m: int = 48
    tau: int = 3
    top_k: int = 32           # rows retrieved by sim_hard, eta and ubr4ctr
    hash_seed: int = 1234
    family: str = "dense"     # sdim's hash family: "dense" | "srht"


class InterestModule(nn.Module):
    def __init__(self, cfg: InterestConfig, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.kind not in INTEREST_KINDS:
            raise ValueError(f"unknown interest kind {cfg.kind!r} (have {INTEREST_KINDS})")
        dev = resolve_device(device)
        self.cfg = cfg
        if cfg.kind == "sdim":
            self.engine = SDIMEngine(EngineConfig(
                m=cfg.m, tau=cfg.tau, d=cfg.d, family=cfg.family,
                hash_seed=cfg.hash_seed), device=dev)
            self.register_buffer("R", self.engine.R)
        elif cfg.kind == "eta":
            self.register_buffer("R", make_hash_family(EngineConfig(
                m=cfg.m, tau=cfg.tau, d=cfg.d, hash_seed=cfg.hash_seed), dev))
        elif cfg.kind == "din_mlp":
            self.din = DinActivationUnit(cfg.d, device=dev, generator=generator)
        elif cfg.kind == "ubr4ctr":
            self.ubr = retrieval.UBR4CTRLite(cfg.d, cfg.top_k, device=dev,
                                             generator=generator)

    def forward(self, q: torch.Tensor, seq: torch.Tensor,
                mask: Optional[torch.Tensor], seq_cat: Optional[torch.Tensor] = None,
                q_cat: Optional[torch.Tensor] = None) -> torch.Tensor:
        """q (B, d) or (B, C, d) against seq (B, L, d) -> q's shape, in
        seq's dtype. ``seq_cat`` (B, L) and ``q_cat`` (B,) / (B, C), the
        category ids, are read by ``sim_hard`` only."""
        cfg = self.cfg
        kind = cfg.kind
        if kind == "none":
            return torch.zeros((*q.shape[:-1], seq.shape[-1]), dtype=seq.dtype,
                               device=seq.device)
        if kind == "sdim":
            return self.engine.attend(q, seq, mask, R=self.R)
        if kind == "sdim_expected":
            return sdim.sdim_expected_attention(q, seq, mask, cfg.tau)
        if kind == "target":
            single = q.ndim == 2
            qc = (q[:, None, :] if single else q).float().contiguous()
            if mask is None:
                mask = torch.ones(seq.shape[:2], dtype=torch.float32, device=seq.device)
            out = target_attention_flash(qc, seq.contiguous(), mask.float().contiguous())
            return (out[:, 0] if single else out).to(seq.dtype)
        if kind == "din_mlp":
            return self.din(q, seq, mask)
        if kind == "avg":
            out = retrieval.avg_pooling(seq, mask)
            return out if q.ndim == 2 else out[:, None, :].expand(*q.shape[:-1], seq.shape[-1])
        if kind == "sim_hard":
            if seq_cat is None or q_cat is None:
                raise ValueError("interest kind 'sim_hard' needs seq_cat and q_cat")
            return retrieval.sim_hard(q, seq, mask, seq_cat, q_cat, cfg.top_k)
        if kind == "eta":
            return retrieval.eta(q, seq, mask, self.R, cfg.top_k)
        return self.ubr(q, seq, mask)

    apply = forward
