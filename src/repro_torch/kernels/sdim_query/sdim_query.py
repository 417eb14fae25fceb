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
they do not fit (``query_plan`` on the card's opt-in shared memory: MLA's
latent, d = 512: 416 KB against 227 KB; d = 256 at tau = 4; m = 500, where
R alone is 256,000 B) the wrapper launches the wide path instead
(``csrc/wide_query.cuh``: a CTA of 256 threads a tile of ``wide_tile``
candidates of one user, R and the tile staged by one bulk copy, or R read
from device memory where it does not fit a CTA, the selected rows in
chunks of ``gc`` groups, each selected row's norm summed in one fixed
order by whichever CTA reads it); ``sdim_fused_serve`` takes the same body
at the same shape, so its reads give these bits. tau 5..10 (32..1,024
buckets a group) launch the large-tau path
(``csrc/sdim_query_large_tau.cu``: sdim_fused_serve's large-tau body, a
team of eight lanes a (candidate, group) hashing and reading only the row
it selects, its columns in a loop at d > 128), as the backward does (a CTA a slice of
``query_backward_large_tau_splits`` whole groups lists the candidates by
bucket, reads only the selected rows and writes the rest +0; more than
``MAX_BWD_CANDS`` candidates are listed in chunks of that many, each
selected row's partial gradient carried from chunk to chunk in its own row
of dT: ``query_backward_large_tau_path``).

Where autograd records the call (grad mode on, the table requiring grad)
the wrapper goes through ``SDIMQueryFn``, whose backward is
``sdim_query_backward``: the CUDA kernel ``csrc/sdim_query_backward.cu`` on
the card (a CTA a slice of ``query_backward_splits`` groups: a team of
eight lanes a row reads a selected row once and writes the rest +0 unread;
no TPU kernel corresponds to it: the JAX package differentiates the XLA
formulation), its closed-form plain version on the CPU. The
candidates reach the output only through their signatures, comparisons
with no gradient, so q (like the buffer R) gets none; the table's is, with
t = T[b,g,u] and n = sqrt(|t|^2 + 1e-12) (eps inside the sqrt, as
``core/sdim.py:l2_normalize``):
  g[b,g,u]  = sum over the candidates c with sig_g(q_bc) = u of dout[b,c] / G
  dT[b,g,u] = (g - t^ (t^ . g)) / n,   t^ = t / n.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import sdim, simhash
from repro_torch.kernels import _build
from repro_torch.kernels.sdim_bucket.sdim_bucket import MAX_TAU, large_tau_list_splits

MAX_BWD_CANDS = 16384   # candidates a chunk of the large-tau backward lists in shared memory
WIDE_MAX_CANDS = 8      # csrc/wide_query.cuh kWideMaxCands: candidates a CTA of the wide path
MAX_BWD_D = 2048        # the backward's rows in a warp's registers (tau <= 4)


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


def wide_tile(B: int, C: int, n_sm: int, ctas: Callable[[int], int]) -> int:
    """Candidates a CTA of the wide path (``csrc/wide_query.cuh``): the
    fewest, 1..``WIDE_MAX_CANDS``, whose B * ceil(C / tile) CTAs the
    ``n_sm`` SMs hold in one wave (``ctas(tile)`` an SM: every CTA stages
    all of R, so more CTAs than fit one wave only queue), else the most
    that fit a CTA. ``ctas(tile)``: the CTAs of ``tile`` candidates an SM
    holds at once (``launch_plan`` asks the card; 0 where a CTA does not
    fit; ``query_plan`` makes sure one candidate does)."""
    most = 1
    for tile in range(1, WIDE_MAX_CANDS + 1):
        n = ctas(tile)
        if B * -(-C // tile) <= n_sm * n:
            return tile
        most = tile if n > 0 else most
    return most


QUERY_CANDS = 32   # csrc/fused_query.cuh kCands: candidates a pass of the fused body


def _a16(n: int) -> int:
    return -(-n // 16) * 16


def fused_smem(G: int, U: int, d: int, m: int) -> int:
    """The fused body's shared memory a CTA (``fused_layout`` in
    ``csrc/fused_query.cuh``): R, the user's whole normalized table, a pass
    of candidates and their signatures, two mbarriers."""
    return (_a16(4 * m * d) + _a16(4 * G * U * d) + _a16(4 * QUERY_CANDS * d)
            + _a16(4 * G * QUERY_CANDS) + 16)


def wide_smem(G: int, d: int, m: int, tile: int, elem: int = 4, gc: Optional[int] = None,
              r_staged: bool = True) -> int:
    """The wide path's shared memory a CTA (``wide_layout`` in
    ``csrc/wide_query.cuh``): the tile's candidates; one region for R
    (where staged), then for two buffers of a chunk of ``gc`` selected rows
    (``elem`` bytes a value) and its normalized rows; the projections,
    signatures, the mbarrier."""
    gc = G if gc is None else gc
    rows = 2 * _a16(elem * gc * d) + _a16(4 * gc * d)
    region = max(_a16(4 * m * d), rows) if r_staged else rows
    return _a16(4 * tile * d) + region + _a16(4 * tile * m) + _a16(4 * tile * G) + 8


@functools.lru_cache(maxsize=None)
def query_plan(G: int, U: int, d: int, m: int, elem: int, optin: int) -> tuple[str, int, bool]:
    """The body that sdim_query and sdim_fused_serve launch at tau <= 4 on a
    card whose CTA may opt in to ``optin`` bytes of shared memory (232,448
    on the H100), for a table of ``elem`` bytes a value: ``("fused", G,
    True)`` where the fused body's shared memory fits (``fused_smem``); else
    ``("wide", gc, r_staged)``: R staged where it fits beside one candidate
    and one group's rows (``r_staged``; else read from device memory, as at
    m = 500, d = 128), and ``gc`` the most groups a chunk of selected rows
    that fit beside one candidate. The choice of body does not depend on
    ``elem``, so both entry points take one body at a shape. Raises where
    not even one group's rows fit (d past ~14,500 for fp32 tables)."""
    if fused_smem(G, U, d, m) <= optin:
        return "fused", G, True
    r_staged = wide_smem(G, d, m, 1, elem, 1, True) <= optin
    for gc in range(G, 0, -1):
        if wide_smem(G, d, m, 1, elem, gc, r_staged) <= optin:
            return "wide", gc, r_staged
    raise ValueError(f"sdim_query: a row of d = {d} does not fit the wide path's shared memory "
                     f"({wide_smem(G, d, m, 1, elem, 1, False)} bytes against {optin})")


def launch_plan(B: int, C: int, G: int, d: int, tau: int, dtype: torch.dtype,
                dev: torch.device, store: bool = False) -> tuple[int, int, int]:
    """(tile, gc, r_staged) of a launch at tau <= 4 on ``dev``: tile 0 for
    the fused body, else ``wide_tile`` with ``dev``'s SM count and the
    wide path's capacity (``store``: sdim_fused_serve's instance) at
    ``query_plan``'s chunk of ``gc`` groups and R ``r_staged``. At tau
    5..10 (the large-tau gather) only whether a row fits: its wide variant's
    smallest CTA holds one row, one candidate and its running sums (12 d
    bytes, ``fused_query_large_tau_smem``)."""
    if tau > 4:
        if d > 128 and 12 * d > _build.smem_optin(dev):
            raise ValueError(f"sdim_query: a row of d = {d} does not fit the large-tau "
                             f"gather's shared memory")
        return 0, G, 1
    body, gc, r_staged = query_plan(G, 1 << tau, d, G * tau, dtype.itemsize,
                                    _build.smem_optin(dev))
    if body == "fused":
        return 0, G, 1
    code = _build.DTYPE_CODES[dtype]
    entry = "sdim_fused_serve_wide_ctas" if store else "sdim_query_wide_ctas"
    fit = lambda tile: _build.clusters(entry, dev, code, G, d, tau, tile, gc, int(r_staged))
    return wide_tile(B, C, _build.sm_count(dev), fit), gc, int(r_staged)


def launch_wide_tile(B: int, C: int, G: int, d: int, tau: int, table_dtype: torch.dtype,
                     dev: torch.device) -> int:
    """sdim_query's tile at (B, C, G, d, tau) on ``dev`` (``launch_plan``):
    0 where it launches another body."""
    return launch_plan(B, C, G, d, tau, table_dtype, dev)[0]


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
    if not 1 <= tau <= MAX_TAU or d % 4 or G * U * d * table.element_size() % 16:
        raise ValueError(f"sdim_query: the kernel takes tau 1..{MAX_TAU}, d a multiple of 4 "
                         f"and a user's table of G*U*d values in whole 16-byte loads; got tau "
                         f"{tau}, G {G}, U {U}, d {d}, {table.dtype}")
    if q.dtype != torch.float32 or R.dtype != torch.float32:
        raise TypeError("sdim_query: q and R must be float32")
    dev = _build.require_cuda("sdim_query", q, table, R)
    _build.require_aligned("sdim_query", q, table, R)
    out = torch.empty((B, C, d), dtype=torch.float32, device=dev)
    if B == 0 or C == 0:
        return out
    tile, gc, r_staged = launch_plan(B, C, G, d, tau, table.dtype, dev)
    lib = _build.load()
    with _build.on_device(dev):
        err = lib.sdim_query(table.data_ptr(), code, q.data_ptr(), R.data_ptr(),
                             out.data_ptr(), B, C, G, U, d, m, tau, tile, gc, r_staged,
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
    """Signature-group slices per user, one CTA each (a team of eight lanes
    a row, up to 256 threads; a few KB of shared memory at C <= 32): as many
    as give the ``n_sm`` SMs two CTAs each, at most G."""
    return max(1, min(G, 2 * n_sm // max(B, 1)))


def query_backward_large_tau_splits(B: int, G: int, U: int, C: int, d: int, tau: int,
                                    n_sm: int) -> tuple[int, int, int]:
    """(Gs, slices, threads) of the large-tau backward
    (``csrc/sdim_query_large_tau.cu``): ``large_tau_list_splits`` over a
    chunk of the user's C candidates."""
    return large_tau_list_splits(B, G, U, min(C, MAX_BWD_CANDS), d, tau, n_sm, reread=False)


def query_backward_large_tau_path(C: int) -> str:
    """The large-tau backward's path for C candidates a user: ``"lists"``
    (one list a bucket of all C, ``row_lanes(C, d)`` lanes a pair) up to
    ``MAX_BWD_CANDS``, else ``"chunked"`` (chunks of that many, 4 lanes a
    pair at any d)."""
    return "lists" if C <= MAX_BWD_CANDS else "chunked"


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
    if not 1 <= tau <= MAX_TAU or d % 4 or d > MAX_BWD_D or tau > 4 and d > 128:
        raise ValueError(f"sdim_query_backward: the kernel takes tau 1..{MAX_TAU} and d a "
                         f"multiple of 4 up to {MAX_BWD_D} (above tau 4: d up to 128); got "
                         f"tau {tau}, d {d}, C {C}")
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
