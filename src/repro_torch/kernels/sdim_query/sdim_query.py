"""sdim_query: candidate hash + own-bucket read + ℓ2 combine (Eq. 12).

Wrapper of the CUDA kernel ``csrc/sdim_query.cu`` (which replaces the Pallas
kernel ``repro/kernels/sdim_query/sdim_query.py:52``) and its plain PyTorch
version ``sdim_query_ref``. The wrapper runs the plain version for CPU
tensors only; for CUDA tensors it launches the kernel or raises.
``sdim_query.launches`` counts kernel launches. The kernel is
``sdim_fused_serve``'s body with user b reading table row b: a thread-block
cluster per user splits the table's rows and the candidates, so each row is
read from device memory and normalized once. That body keeps R, the user's
whole normalized table and 32 candidates in a CTA's shared memory; where
they do not fit (MLA's latent, d = 512: 416 KB against 227 KB) the kernel's
entry point launches the wide path instead (``csrc/wide_query.cuh``: the
cluster splits the columns and merges its partial sums in rank order); a
shape neither launches raises. tau 5..10 (32..1,024 buckets a group) launch
the large-tau path (``csrc/sdim_query_large_tau.cu``: each candidate reads
and normalizes only the G rows it selects), as the backward does.

Where autograd records the call (grad mode on, the table requiring grad)
the wrapper goes through ``SDIMQueryFn``, whose backward is
``sdim_query_backward``: the CUDA kernel ``csrc/sdim_query_backward.cu`` on
the card (no TPU kernel corresponds to it: the JAX package differentiates
the XLA formulation), its closed-form plain version on the CPU. The
candidates reach the output only through their signatures, comparisons
with no gradient, so q (like the buffer R) gets none; the table's is, with
t = T[b,g,u] and n = sqrt(|t|^2 + 1e-12) (eps inside the sqrt, as
``core/sdim.py:l2_normalize``):
  g[b,g,u]  = sum over the candidates c with sig_g(q_bc) = u of dout[b,c] / G
  dT[b,g,u] = (g - t^ (t^ . g)) / n,   t^ = t / n.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import sdim, simhash
from repro_torch.kernels import _build
from repro_torch.kernels.sdim_bucket.sdim_bucket import MAX_TAU

MAX_BWD_CANDS = 16384   # the large-tau backward's candidate buckets in shared memory


def sdim_query_ref(q: torch.Tensor, table: torch.Tensor, R: torch.Tensor,
                   tau: int) -> torch.Tensor:
    """(B, C, d), (B, G, U, d) -> (B, C, d) fp32."""
    return sdim.fused_query(table, simhash.signatures(q, R, tau))


def sdim_query(q: torch.Tensor, table: torch.Tensor, R: torch.Tensor,
               tau: int) -> torch.Tensor:
    """Candidates q (B, C, d) fp32 against bucket tables (B, G, U, d)
    fp32|bf16 -> interest (B, C, d) fp32; differentiable in the table."""
    if _build.needs_grad(q, table, R):
        return SDIMQueryFn.apply(q, table, R, tau)
    return _query(q, table, R, tau)


class SDIMQueryFn(torch.autograd.Function):
    """``sdim_query`` with its gradient in the table (``sdim_query_backward``);
    q and R get none (signatures are comparisons)."""

    @staticmethod
    def forward(ctx, q, table, R, tau):
        ctx.tau = tau
        ctx.save_for_backward(q, table, R)
        return _query(q, table, R, tau)

    @staticmethod
    def backward(ctx, dout):
        q, table, R = ctx.saved_tensors
        dT = None
        if ctx.needs_input_grad[1]:
            dT = sdim_query_backward(dout.contiguous(), q, table.float().contiguous(), R,
                                     ctx.tau).to(table.dtype)
        return None, dT, None, None


def _query(q, table, R, tau):
    if q.device.type == "cpu":
        return sdim_query_ref(q, table, R, tau)
    B, C, d = q.shape
    m = R.shape[0]
    G, U = m // tau, 1 << tau
    if m % tau or table.shape != (B, G, U, d) or R.shape != (m, d):
        raise ValueError(f"sdim_query: shapes q {tuple(q.shape)} table "
                         f"{tuple(table.shape)} R {tuple(R.shape)} tau {tau}")
    code = _build.dtype_code("sdim_query", table, (torch.float32, torch.bfloat16))
    if (not 1 <= tau <= MAX_TAU or d % 4 or G * U * d * table.element_size() % 16
            or tau > 4 and d > 128):
        raise ValueError(f"sdim_query: the kernel takes tau 1..{MAX_TAU} (d up to 128 above "
                         f"tau 4), d a multiple of 4 and a user's table of G*U*d values in "
                         f"whole 16-byte loads; got tau {tau}, G {G}, U {U}, d {d}, "
                         f"{table.dtype}")
    if q.dtype != torch.float32 or R.dtype != torch.float32:
        raise TypeError("sdim_query: q and R must be float32")
    dev = _build.require_cuda("sdim_query", q, table, R)
    _build.require_aligned("sdim_query", q, table, R)
    out = torch.empty((B, C, d), dtype=torch.float32, device=dev)
    if B == 0 or C == 0:
        return out
    lib = _build.load()
    with _build.on_device(dev):
        err = lib.sdim_query(table.data_ptr(), code, q.data_ptr(), R.data_ptr(),
                             out.data_ptr(), B, C, G, U, d, m, tau,
                             _build.stream(dev))
    _build.check(err, "sdim_query")
    sdim_query.launches += 1
    return out


sdim_query.launches = 0


def sdim_query_backward_ref(dout: torch.Tensor, q: torch.Tensor, table: torch.Tensor,
                            R: torch.Tensor, tau: int) -> torch.Tensor:
    """dout (B, C, d) -> dT (B, G, U, d) fp32 in closed form."""
    B, G, U, d = table.shape
    hits = F.one_hot(simhash.signatures(q, R, tau).long(), U).float()    # (B, C, G, U)
    g = torch.einsum("bcgu,bcd->bgud", hits, dout.float() / G)
    t = table.float()
    n = torch.sqrt(torch.sum(t * t, dim=-1, keepdim=True) + 1e-12)
    th = t / n
    return (g - th * torch.sum(th * g, dim=-1, keepdim=True)) / n


def query_backward_splits(B: int, G: int, n_sm: int) -> int:
    """Signature-group slices per user, one CTA each (256 threads, a few KB
    of shared memory): as many as fill the ``n_sm`` SMs in one wave at two
    CTAs an SM, at most G."""
    return max(1, min(G, 2 * n_sm // max(B, 1)))


def sdim_query_backward(dout: torch.Tensor, q: torch.Tensor, table: torch.Tensor,
                        R: torch.Tensor, tau: int) -> torch.Tensor:
    """Gradient of ``sdim_query`` in the table: dout (B, C, d) fp32 -> dT
    (B, G, U, d) fp32 (every row written, 0 where no candidate reads it)."""
    if q.device.type == "cpu":
        return sdim_query_backward_ref(dout, q, table, R, tau)
    return sdim_query_backward_cuda(dout, q, table, R, tau)


def sdim_query_backward_cuda(dout: torch.Tensor, q: torch.Tensor, table: torch.Tensor,
                             R: torch.Tensor, tau: int,
                             splits: Optional[int] = None) -> torch.Tensor:
    """The kernel launch of ``sdim_query_backward`` with ``splits``
    signature-group slices per user (None: ``query_backward_splits``)."""
    B, C, d = q.shape
    m = R.shape[0]
    G, U = m // tau, 1 << tau
    if (m % tau or table.shape != (B, G, U, d) or R.shape != (m, d)
            or dout.shape != (B, C, d)):
        raise ValueError(f"sdim_query_backward: shapes dout {tuple(dout.shape)} q "
                         f"{tuple(q.shape)} table {tuple(table.shape)} R {tuple(R.shape)} "
                         f"tau {tau}")
    if not 1 <= tau <= MAX_TAU or d % 4 or tau > 4 and (d > 128 or C > MAX_BWD_CANDS):
        raise ValueError(f"sdim_query_backward: the kernel takes tau 1..{MAX_TAU} and d a "
                         f"multiple of 4 (above tau 4: d up to 128 and C up to "
                         f"{MAX_BWD_CANDS}); got tau {tau}, d {d}, C {C}")
    for name, t in (("dout", dout), ("q", q), ("table", table), ("R", R)):
        if t.dtype != torch.float32:
            raise TypeError(f"sdim_query_backward: {name} must be float32")
    dev = _build.require_cuda("sdim_query_backward", dout, q, table, R)
    _build.require_aligned("sdim_query_backward", dout, q, table, R)
    if splits is None:
        splits = query_backward_splits(B, G, _build.sm_count(dev))
    if not 1 <= splits <= G:
        raise ValueError(f"sdim_query_backward: {splits} group slices of G = {G}")
    out = torch.empty((B, G, U, d), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    lib = _build.load()
    with _build.on_device(dev):
        err = lib.sdim_query_backward(dout.data_ptr(), q.data_ptr(), table.data_ptr(),
                                      R.data_ptr(), out.data_ptr(), B, C, G, U, d, m, tau,
                                      splits, _build.stream(dev))
    _build.check(err, "sdim_query_backward")
    sdim_query_backward.launches += 1
    return out


sdim_query_backward.launches = 0
