"""Long-term user-interest module (paper: SDIM is architecture-free, §4.4).

Counterpart of ``repro/core/interest.py`` for kinds ``sdim`` (the paper),
``target`` (exact target attention over the whole history: the DIN
long-sequence baseline SDIM approximates, through the
``target_attention_flash`` kernel) and ``none``; the retrieval baselines and
the other kinds are not ported yet. The hash family R of ``sdim`` is a
non-trainable buffer (checkpointed with the model, excluded from
training). Both kernel kinds train: gradients reach the behaviors (and,
for ``target``, the candidates) through the kernels' autograd Functions.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.core.engine import EngineConfig, SDIMEngine
from repro_torch.device import DeviceLike
from repro_torch.kernels.target_attn.target_attn import target_attention_flash

INTEREST_KINDS = ("sdim", "target", "none")


@dataclasses.dataclass(frozen=True)
class InterestConfig:
    kind: str = "sdim"
    d: int = 32
    m: int = 48
    tau: int = 3
    hash_seed: int = 1234


class InterestModule(nn.Module):
    def __init__(self, cfg: InterestConfig, device: DeviceLike = "cuda"):
        super().__init__()
        if cfg.kind not in INTEREST_KINDS:
            raise NotImplementedError(
                f"interest kind {cfg.kind!r} is not ported (have {INTEREST_KINDS})")
        self.cfg = cfg
        if cfg.kind == "sdim":
            self.engine = SDIMEngine(EngineConfig(
                m=cfg.m, tau=cfg.tau, d=cfg.d, hash_seed=cfg.hash_seed),
                device=device)
            self.register_buffer("R", self.engine.R)

    def forward(self, q: torch.Tensor, seq: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        """q (B, d) or (B, C, d) against seq (B, L, d) -> q's shape, in
        seq's dtype."""
        if self.cfg.kind == "none":
            return torch.zeros((*q.shape[:-1], seq.shape[-1]), dtype=seq.dtype,
                               device=seq.device)
        if self.cfg.kind == "target":
            single = q.ndim == 2
            qc = (q[:, None, :] if single else q).float().contiguous()
            if mask is None:
                mask = torch.ones(seq.shape[:2], dtype=torch.float32, device=seq.device)
            out = target_attention_flash(qc, seq.contiguous(), mask.float().contiguous())
            return (out[:, 0] if single else out).to(seq.dtype)
        return self.engine.attend(q, seq, mask, R=self.R)

    apply = forward
