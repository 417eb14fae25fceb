"""(m, τ)-parameterized SimHash (paper §3.3), dense hash family.

Counterpart of ``repro/core/simhash.py``. Conventions kept exactly: the
projection is fp32, bit = [r·x >= 0] (sign(0) := +1), and every τ bits of a
group pack little-endian (weight ``1 << t``) into one of 2^τ bucket ids.
The SRHT family is not ported yet.
"""
from __future__ import annotations

import torch


def make_hashes(generator: torch.Generator, m: int, d: int) -> torch.Tensor:
    """R ∈ R^{m×d}, rows r_i ~ N(0, I_d), drawn from ``generator`` on its
    device. (Torch cannot replay ``jax.random``: parity tests pass the JAX
    package's R in.)"""
    return torch.randn((m, d), generator=generator, dtype=torch.float32,
                       device=generator.device)


def hash_codes(x: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """x (..., d) -> bits (..., m) in {0,1} (int32); bit = [r·x >= 0]."""
    proj = torch.einsum("...d,md->...m", x.float(), R.float())
    return (proj >= 0).to(torch.int32)


def pack_signatures(codes: torch.Tensor, tau: int) -> torch.Tensor:
    """codes (..., m) bits -> bucket ids (..., m/τ) ∈ [0, 2^τ) (int32)."""
    *lead, m = codes.shape
    assert m % tau == 0, (m, tau)
    grouped = codes.reshape(*lead, m // tau, tau)
    weights = 1 << torch.arange(tau, dtype=torch.int32, device=codes.device)
    return (grouped * weights).sum(dim=-1, dtype=torch.int32)


def signatures(x: torch.Tensor, R: torch.Tensor, tau: int) -> torch.Tensor:
    """x (..., d) -> bucket ids (..., G)."""
    return pack_signatures(hash_codes(x, R), tau)
