"""bse_serve: encode + ℓ2-normalize + multi-candidate query in one launch,
for inline serving: the bucket table never reaches device memory.

Wrapper of the CUDA kernel ``csrc/bse_serve.cu`` (which replaces the Pallas
kernel ``repro/kernels/sdim_serve/sdim_serve.py:68``) and its plain PyTorch
version ``bse_serve_ref``. The wrapper runs the plain version for CPU
tensors only; for CUDA tensors it launches the kernel or raises.
``bse_serve.launches`` counts kernel launches. Where the kernel's cluster
body cannot hold the table (tau 5..10, or more groups than its eight CTAs
spread: tau = 1 at m = 48) the C entry point launches the large-tau path
(``csrc/bse_serve_large_tau.cu``: only the buckets the candidates select
are summed, by CTAs of ``serve_large_tau_splits`` group slices and rank
chunks, into a scratch of ``serve_large_tau_work_floats`` floats the
wrapper allocates, and read back in a second kernel). The kernel has no
backward (it serves): on CUDA the wrapper raises where autograd would
record the call.
"""
from __future__ import annotations

import torch

from repro_torch.core import sdim
from repro_torch.kernels import _build
from repro_torch.kernels.sdim_bucket.sdim_bucket import MAX_TAU

MAX_CLUSTER = 8           # bse_serve.cu kMaxCluster: CTAs a user, each a slice of the groups
MAX_GROUP_COLUMNS = 512   # bse_serve.cu kMaxCells * kThreads: (group, column) sums a CTA


def cluster_body_takes(G: int, d: int, tau: int) -> bool:
    """Whether ``bse_serve.cu``'s cluster body takes the shape (tau <= 4 and
    each CTA's groups within its registers); else the large-tau path runs."""
    return tau <= 4 and -(-G // min(MAX_CLUSTER, G)) * d <= MAX_GROUP_COLUMNS


SERVE_CELLS = 4           # bse_serve_large_tau.cu kServeCells: (row, float4 column) sums a thread
SERVE_THREADS = 512       # kServeThreads
SERVE_MAX_PLANES = 10     # kServeMaxPlanes: projections a kernel-1 CTA hashes a row


def serve_large_tau_work_floats(B: int, C: int, G: int, U: int, d: int) -> int:
    """Scratch of the large-tau path: the selected rows of each (user,
    group), min(U, C) of d, then each candidate's rank in each group
    (B, C, G) int32."""
    return B * G * min(U, C) * d + B * C * G


def serve_large_tau_splits(B: int, G: int, U: int, C: int, d: int, tau: int,
                           n_sm: int) -> tuple[int, int, int, int]:
    """(Gs, slices, K, chunks) of the large-tau path's first kernel
    (``serve_split`` in ``csrc/bse_serve_large_tau.cu``): a CTA holds Gs
    groups x K ranks of d / 4 float4 sums, at most SERVE_CELLS a thread,
    and hashes Gs * tau <= SERVE_MAX_PLANES projections a row; as many
    group slices as B * slices * chunks CTAs, one an SM, fit in ``n_sm``,
    each slice as even as it goes."""
    every, nq = min(U, C), d // 4
    cap = SERVE_CELLS * SERVE_THREADS // nq
    chunks = -(-every // cap)
    K = -(-every // chunks)
    gs_max = min(G, SERVE_MAX_PLANES // tau, max(1, cap // K))
    per_user = max(1, B * chunks)
    slices = max(-(-G // gs_max), min(G, n_sm // per_user), 1)
    Gs = -(-G // slices)
    return Gs, -(-G // Gs), K, chunks


GATHER_TEAMS = 64         # large_tau.cuh kGatherTeams: eight-lane teams a gather CTA
GATHER_WAVE = 2048        # kGatherWaveThreads: threads an SM holds at once


def gather_shape(B: int, C: int, G: int, n_sm: int) -> tuple[int, int]:
    """(candidates, teams) of a CTA of the large-tau gather body
    (``gather_shape`` in ``kernels/sdim_bucket/csrc/large_tau.cuh``, which
    the large-tau paths of this kernel and of ``sdim_fused_serve`` run): a
    team of eight lanes a (candidate, group), the groups in as few even
    passes as keep the burst's teams within one wave, 4..64 teams a
    candidate; as many candidates as fill 64 teams, halved while the CTAs
    would number fewer than the SMs."""
    most = min(GATHER_TEAMS, max(4, n_sm * GATHER_WAVE // (8 * max(B, 1) * max(C, 1))))
    passes = -(-G // most)
    teams = max(4, -(-G // passes))
    cands = GATHER_TEAMS // teams
    while cands > 1 and B * -(-C // cands) < n_sm:
        cands //= 2
    return cands, teams


def bse_serve_ref(q: torch.Tensor, seq: torch.Tensor, mask: torch.Tensor,
                  R: torch.Tensor, tau: int) -> torch.Tensor:
    """(B, C, d), (B, L, d), (B, L) -> (B, C, d) fp32 == query ∘ encode."""
    return sdim.sdim_attention(q.float(), seq.float(), mask, R, tau)


def bse_serve(q: torch.Tensor, seq: torch.Tensor, mask: torch.Tensor,
              R: torch.Tensor, tau: int) -> torch.Tensor:
    """Candidates q (B, C, d) fp32 against behaviors seq (B, L, d)
    fp32|bf16 with mask (B, L) fp32 and hash family R (m, d) -> interest
    (B, C, d) fp32."""
    if q.device.type == "cpu":
        return bse_serve_ref(q, seq, mask, R, tau)
    _build.refuse_grad("bse_serve", q, seq, mask, R)
    B, C, d = q.shape
    L = seq.shape[1]
    m = R.shape[0]
    if (m % tau or seq.shape != (B, L, d) or mask.shape != (B, L)
            or R.shape != (m, d)):
        raise ValueError(f"bse_serve: shapes q {tuple(q.shape)} seq {tuple(seq.shape)} "
                         f"mask {tuple(mask.shape)} R {tuple(R.shape)} tau {tau}")
    G, U = m // tau, 1 << tau
    if not 1 <= tau <= MAX_TAU or d % 4 or d > 128:
        raise ValueError(f"bse_serve: the kernel takes tau 1..{MAX_TAU} and d a multiple "
                         f"of 4 up to 128; got tau {tau}, d {d}, G {G}")
    code = _build.dtype_code("bse_serve", seq, (torch.float32, torch.bfloat16))
    for name, t in (("q", q), ("mask", mask), ("R", R)):
        if t.dtype != torch.float32:
            raise TypeError(f"bse_serve: {name} must be float32")
    dev = _build.require_cuda("bse_serve", q, seq, mask, R)
    _build.require_aligned("bse_serve", q, seq, R)
    out = torch.empty((B, C, d), dtype=torch.float32, device=dev)
    if B == 0 or C == 0:
        return out
    work = (None if cluster_body_takes(G, d, tau) else
            torch.empty(serve_large_tau_work_floats(B, C, G, U, d), dtype=torch.float32,
                        device=dev))
    lib = _build.load()
    with _build.on_device(dev):
        err = lib.sdim_bse_serve(q.data_ptr(), seq.data_ptr(), code, mask.data_ptr(),
                                 R.data_ptr(), out.data_ptr(), _build.ptr(work), B, L, C, G,
                                 U, d, m, tau, _build.stream(dev))
    _build.check(err, "bse_serve")
    bse_serve.launches += 1
    return out


bse_serve.launches = 0
