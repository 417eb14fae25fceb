"""(m, τ)-parameterized SimHash (paper §3.3) and the SRHT hash family.

Counterpart of ``repro/core/simhash.py``. Conventions kept exactly: the
projection is fp32, bit = [r·x >= 0] (sign(0) := +1), and every τ bits of a
group pack little-endian (weight ``1 << t``) into one of 2^τ bucket ids.

* ``collision_expectation`` — E[p̃] = (1 − arccos(cos θ)/π)^τ (Eq. 13).
* ``srht_hashes`` / ``SRHTHashes`` — the subsampled randomized Hadamard
  transform (the paper's "Approximating Random Projection" citation):
  x -> (H·D2·H·D1 x)[rows]. ``dense_matrix`` turns it into the (m, d)
  operand the kernels take; its entries are integers of magnitude at most
  d_pad, exact in fp32, so it equals the JAX package's bit for bit given
  the same d1, d2 and rows.
"""
from __future__ import annotations

import dataclasses
import math

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


def _balanced_clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` with JAX's gradient: the incoming gradient
    MULTIPLIED by 1 inside (lo, hi), 0.5 at a bound, 0 outside. So an
    infinite incoming gradient outside the range gives NaN, as ``jax.grad``
    gives it, where ``torch.clamp`` would give 0."""
    x_det = x.detach()
    slope = (torch.where(x_det > lo, 1.0, torch.where(x_det == lo, 0.5, 0.0))
             * torch.where(x_det < hi, 1.0, torch.where(x_det == hi, 0.5, 0.0)))
    return torch.clamp(x_det, lo, hi) + (x - x_det) * slope


def collision_expectation(cos_sim: torch.Tensor, tau: int) -> torch.Tensor:
    """E[p̃] = (1 − arccos(cos θ)/π)^τ. ``cos_sim`` must be a cosine (unit-norm
    dot product); clipped to [−1, 1] for arccos, with the JAX package's
    gradient (``_balanced_clip``): the derivative of arccos is infinite at
    ±1, so a cosine of 1 gives a non-finite gradient here as there."""
    c = _balanced_clip(cos_sim, -1.0, 1.0)
    return (1.0 - torch.arccos(c) / math.pi) ** tau


# ---------------------------------------------------------------------------
# SRHT: subsampled randomized Hadamard transform (fast JL projection)
# ---------------------------------------------------------------------------
def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def fwht(x: torch.Tensor) -> torch.Tensor:
    """Fast Walsh–Hadamard transform along the last axis (length 2^k), in
    the JAX package's butterfly order: log2(d) stages of reshape + add/sub."""
    d = x.shape[-1]
    assert d & (d - 1) == 0, f"FWHT needs power-of-2 length, got {d}"
    h = 1
    while h < d:
        x = x.reshape(*x.shape[:-1], d // (2 * h), 2, h)
        a, b = x[..., 0, :], x[..., 1, :]
        x = torch.cat([a + b, a - b], dim=-1).reshape(*x.shape[:-3], d)
        h *= 2
    return x


@dataclasses.dataclass(frozen=True)
class SRHTHashes:
    """Structured projection x -> (H·D2·H·D1 x)[rows]: two sign-flip +
    Hadamard rounds, then ``rows`` subsamples m of the d_pad coordinates.
    As in the JAX package, no 1/sqrt(d_pad) is applied (a positive scale
    changes no sign bit)."""

    d1: torch.Tensor      # (d_pad,) ±1 fp32
    d2: torch.Tensor      # (d_pad,) ±1 fp32
    rows: torch.Tensor    # (m,) int64 indices into d_pad
    d: int
    d_pad: int

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """x (..., d) -> pre-sign projections (..., m) via two FWHT rounds."""
        xf = x.float()
        pad = self.d_pad - self.d
        if pad:
            xf = torch.cat([xf, xf.new_zeros((*x.shape[:-1], pad))], dim=-1)
        y = fwht(xf * self.d1)
        y = fwht(y * self.d2)
        return torch.index_select(y, -1, self.rows)

    def codes(self, x: torch.Tensor) -> torch.Tensor:
        return (self.project(x) >= 0).to(torch.int32)

    def dense_matrix(self) -> torch.Tensor:
        """The (m, d) matrix R with R @ x == project(x): the linear map
        applied to I_d, so the family feeds the kernels' dense operand."""
        return self.project(torch.eye(self.d, dtype=torch.float32,
                                      device=self.d1.device)).T.contiguous()


def srht_hashes(generator: torch.Generator, m: int, d: int) -> SRHTHashes:
    """An SRHT family drawn from ``generator`` on its device: Rademacher d1
    and d2, and m distinct rows of d_pad = next power of two >= max(d, m).
    (Torch cannot replay ``jax.random``: parity tests pass the JAX
    package's d1, d2 and rows in.)"""
    d_pad = _next_pow2(max(d, m))
    dev = generator.device
    sign = lambda: (torch.randint(0, 2, (d_pad,), generator=generator, device=dev)
                    * 2 - 1).float()
    d1, d2 = sign(), sign()
    rows = torch.randperm(d_pad, generator=generator, device=dev)[:m]
    return SRHTHashes(d1=d1, d2=d2, rows=rows, d=d, d_pad=d_pad)


def srht_signatures(x: torch.Tensor, h: SRHTHashes, tau: int) -> torch.Tensor:
    return pack_signatures(h.codes(x), tau)
