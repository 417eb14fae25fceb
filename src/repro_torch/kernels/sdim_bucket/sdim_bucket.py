"""bse_encode: SimHash + signature pack + bucket sum of a behavior batch,
and its gradient.

Wrapper of the CUDA kernel ``csrc/bse_encode.cu`` (which replaces the Pallas
kernel ``repro/kernels/sdim_bucket/sdim_bucket.py:117``) and its plain
PyTorch version ``bse_encode_ref``. The wrapper runs the plain version for
CPU tensors only; for CUDA tensors it launches the kernel or raises.
``bse_encode.launches`` counts kernel launches. The kernel splits each
user's signature groups over ``encode_splits`` CTAs, each of which writes
its slice of the table once (no atomics, no zero-filled output). tau 5..10
(32..1,024 buckets a group, more than a CTA's registers hold) launch the
large-tau path (``csrc/bse_encode_large_tau.cu``: a CTA a slice of
``encode_large_tau_splits`` whole groups lists the user's rows by bucket
and writes each cell once); so does the backward (``csrc/bse_encode_backward_large_tau.cu``:
``encode_backward_large_tau_split`` CTAs a user, each a chunk of its rows,
hashing each valid row once with the forward's arithmetic and gathering its
G rows of dT from a copy of the user's dT in shared memory where it fits,
else from device memory, and reading R from device memory where R does not
fit a CTA either). Both forward paths take any L: a user of more than
``MAX_L`` rows is listed in spans of ``MAX_L`` (``encode_spans``), each
CTA's sums carried from span to span in row order. Rows wider than
``MAX_REG_D`` (d > 128: a lane of the tau <= 4 kernel holds one float4
column of its register sums) take the large-tau path at every tau
(``encode_path``), whose eight lanes a row hash the columns in a loop, as
bucket_of, with R read from device memory (``encode_large_tau_splits``
at d > 128), so a behavior gets the bucket sdim_update's fold gives it.

Where autograd records the call (grad mode on, ``seq`` requiring grad) the
wrapper goes through ``BSEEncodeFn``, whose backward is
``bse_encode_backward``: the CUDA kernel ``csrc/bse_encode_backward.cu`` on
the card (no TPU kernel corresponds to it: the JAX package differentiates
the XLA formulation; at tau <= 4 a cluster of ``backward_splits`` CTAs a
user shares one multicast copy of its dT and R, or, past ``MAX_BWD_SMEM``,
reads dT, and R where it does not fit alone, from device memory:
``backward_layout``), its closed-form plain
version on the CPU. Signatures
are comparisons and carry no gradient, so the gradient of the table
T[b,g,u] = sum_l [sig_g(s_bl) = u] mask_bl s_bl is a gather,
d seq[b,l] = mask[b,l] * sum_g dT[b, g, sig_g(s_bl)]; R is a buffer, and a
mask that requires grad is refused.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import sdim, simhash
from repro_torch.kernels import _build

MAX_CELLS = 16      # (group, bucket) sums a CTA holds in registers (bse_encode.cu kCells)
MAX_L = 32768       # behaviors a span: the forward's lists (of 8-row batches at tau <= 4, of
                    # rows at tau 5..10) live in shared memory; longer users go in spans
MAX_BWD_SMEM = 200 * 1024   # the backward's shared copy of a user's table and of R (tau <= 4)
MAX_TAU = 10        # tau 5..MAX_TAU: the large-tau path (csrc/large_tau.cuh)
MAX_REG_D = 128     # the widest row the register paths hold (csrc/large_tau.cuh kLargeTauCols);
                    # wider rows take the large-tau kernels' wide variants at every tau


def encode_path(d: int, tau: int) -> str:
    """The forward's path: ``"groups"`` (csrc/bse_encode.cu, signature-group
    slices with register sums) at tau <= 4 and d <= ``MAX_REG_D``, else
    ``"lists"`` (csrc/bse_encode_large_tau.cu; its wide variant above
    ``MAX_REG_D``)."""
    return "groups" if tau <= 4 and d <= MAX_REG_D else "lists"


def bse_encode_ref(seq: torch.Tensor, mask: torch.Tensor, R: torch.Tensor,
                   tau: int) -> torch.Tensor:
    """(B, L, d), (B, L), (m, d) -> bucket table (B, G, U, d) fp32."""
    sig = simhash.signatures(seq, R, tau)
    return sdim.bucket_table(seq, sig, mask, 1 << tau)


def encode_spans(L: int) -> int:
    """The spans of at most ``MAX_L`` rows that the forward lists a user of
    L rows in, one after another (one at L <= MAX_L, the path as it was)."""
    return max(1, -(-L // MAX_L))


def encode_splits(B: int, G: int, U: int, n_sm: int) -> int:
    """Signature-group slices per user, one CTA each: as many as fill the
    ``n_sm`` SMs in one wave (a CTA of 512 threads and ~200 KB of shared
    memory takes an SM), at most G, and at least as many as keep a CTA at
    ``MAX_CELLS`` (group, bucket) sums."""
    s_min = -(-G // (MAX_CELLS // U))
    return max(s_min, min(G, n_sm // max(B, 1)))


LIST_SMEM_BUDGET = 48 * 1024   # large_tau.cuh kListSmemBudget: a CTA's shared memory for its groups


def large_tau_list_splits(B: int, G: int, U: int, n: int, d: int, tau: int, n_sm: int,
                          reread: bool) -> tuple[int, int, int]:
    """(Gs, slices, threads) of the large-tau training kernels that list a
    user's n rows by bucket (``list_split`` in ``csrc/large_tau.cuh``): a CTA
    owns Gs whole groups of one user, with their rows of R (tau * d floats a
    group), a list head and a selected-row slot a bucket and a link and a
    key a row (shorts) in shared memory, at least as many slices as keep a
    CTA's groups within ``LIST_SMEM_BUDGET``, each as even as it goes.
    ``reread`` (the forward, whose every slice reads the user's rows): as
    few slices as give each of the ``n_sm`` SMs a CTA, and 256 * k threads
    for the largest k <= 4 that keeps the CTAs within one wave (4 / k an SM);
    else (the backward) 256 threads and as many slices as fit one wave of
    four CTAs an SM."""
    per = 4 * tau * d + 2 * (2 * U + 2 * (-(-n // 8) * 8))
    gs_max = max(1, min(G, LIST_SMEM_BUDGET // per))
    users = max(B, 1)
    slices = -(-G // gs_max)
    if reread:
        while slices < G and users * slices < n_sm:
            slices += 1
    else:
        slices = max(slices, min(G, n_sm * 4 // users))
    Gs = -(-G // slices)
    slices, k = -(-G // Gs), 1
    if reread:
        k = 4
        while k > 1 and users * slices * k > n_sm * 4:
            k //= 2
    return Gs, slices, 256 * k


def encode_large_tau_splits(B: int, G: int, U: int, L: int, d: int, tau: int,
                            n_sm: int) -> tuple[int, int, int]:
    """(Gs, slices, threads) of the large-tau forward
    (``csrc/bse_encode_large_tau.cu``): ``large_tau_list_splits`` over the
    rows of a span of the user's L behaviors, which each slice reads (R
    staged beside the lists up to ``MAX_REG_D``; above, read from device
    memory: no R in the budget)."""
    return large_tau_list_splits(B, G, U, min(L, MAX_L), d if d <= MAX_REG_D else 0, tau, n_sm,
                                 reread=True)


def bse_encode(seq: torch.Tensor, mask: torch.Tensor, R: torch.Tensor,
               tau: int) -> torch.Tensor:
    """Behaviors seq (B, L, d) fp32|bf16 with mask (B, L) and hash family
    R (m, d) -> bucket table (B, G, U, d) fp32; differentiable in seq."""
    if _build.needs_grad(seq, mask, R):
        if mask.requires_grad or R.requires_grad:
            raise ValueError("bse_encode: the gradient flows to seq only; mask and R "
                             "must not require grad")
        return BSEEncodeFn.apply(seq, mask, R, tau)
    return _encode(seq, mask, R, tau)


def _encode(seq, mask, R, tau):
    if seq.device.type == "cpu":
        return bse_encode_ref(seq, mask, R, tau)
    return bse_encode_cuda(seq, mask, R, tau)


class BSEEncodeFn(torch.autograd.Function):
    """``bse_encode`` with its gradient in seq (``bse_encode_backward``)."""

    @staticmethod
    def forward(ctx, seq, mask, R, tau):
        ctx.tau = tau
        ctx.save_for_backward(seq, mask, R)
        return _encode(seq, mask, R, tau)

    @staticmethod
    def backward(ctx, dT):
        seq, mask, R = ctx.saved_tensors
        return bse_encode_backward(dT.contiguous(), seq, mask, R, ctx.tau), None, None, None


def bse_encode_cuda(seq: torch.Tensor, mask: torch.Tensor, R: torch.Tensor,
                    tau: int, splits: Optional[int] = None) -> torch.Tensor:
    """The kernel launch of ``bse_encode`` with ``splits`` signature-group
    slices per user (None: ``encode_splits`` for this device)."""
    B, L, d = seq.shape
    m = R.shape[0]
    if m % tau or R.shape != (m, d) or mask.shape != (B, L):
        raise ValueError(f"bse_encode: shapes seq {tuple(seq.shape)} mask "
                         f"{tuple(mask.shape)} R {tuple(R.shape)} tau {tau}")
    G, U = m // tau, 1 << tau
    if not 1 <= tau <= MAX_TAU or d % 4 or d < 4:
        raise ValueError(f"bse_encode: the kernel takes tau 1..{MAX_TAU} and d a multiple of 4; "
                         f"got tau {tau}, d {d}")
    code = _build.dtype_code("bse_encode", seq, (torch.float32, torch.bfloat16))
    if mask.dtype != torch.float32 or R.dtype != torch.float32:
        raise TypeError("bse_encode: mask and R must be float32")
    dev = _build.require_cuda("bse_encode", seq, mask, R)
    _build.require_aligned("bse_encode", seq, R)
    if splits is None:      # the large-tau path takes no slices
        splits = (encode_splits(B, G, U, _build.sm_count(dev))
                  if encode_path(d, tau) == "groups" else 1)
    if B == 0 or L == 0:
        return torch.zeros((B, G, U, d), dtype=torch.float32, device=dev)
    out = R.new_empty((B, G, U, d))         # fp32 on R's device
    lib = _build.load()
    with _build.on_device(dev):
        err = lib.sdim_bse_encode(seq.data_ptr(), code, mask.data_ptr(), R.data_ptr(),
                                  out.data_ptr(), B, L, G, U, d, m, tau, splits,
                                  _build.stream(dev))
    _build.check(err, "bse_encode")
    bse_encode.launches += 1
    return out


bse_encode.launches = 0


def bse_encode_backward_ref(dT: torch.Tensor, seq: torch.Tensor, mask: torch.Tensor,
                            R: torch.Tensor, tau: int) -> torch.Tensor:
    """dT (B, G, U, d) -> d seq (B, L, d) in seq's dtype: each row's G
    gathered rows of dT summed in group order, times its mask."""
    sig = simhash.signatures(seq, R, tau).long()                   # (B, L, G)
    b = torch.arange(seq.shape[0], device=seq.device)[:, None]
    acc = torch.zeros(seq.shape, dtype=torch.float32, device=seq.device)
    for g in range(dT.shape[1]):
        acc = acc + dT[b, g, sig[..., g]].float()
    return (acc * mask.float()[..., None]).to(seq.dtype)


def backward_layout(G: int, U: int, d: int, m: int) -> str:
    """Where the tau <= 4 backward keeps a user's dT and R
    (``bwd_spills``/``bwd_r_fits`` in ``csrc/bse_encode_backward.cu``):
    ``"shared"`` (one multicast copy of both in a CTA's shared memory)
    while they fit ``MAX_BWD_SMEM``, else ``"spill"`` (dT read from device
    memory, R shared) while R alone fits, else ``"spill_r"`` (both read
    from device memory)."""
    if 4 * (G * U * d + m * d) <= MAX_BWD_SMEM:
        return "shared"
    return "spill" if 4 * m * d <= MAX_BWD_SMEM else "spill_r"


BWD_MAX_CLUSTER = 8   # csrc/bse_encode_backward.cu kBwdMaxCluster: CTAs a user
BWD_WARPS = 8         # warps a CTA of the backward (kBwdWarps)
BWD_ROUND = 16        # rows a warp hashes and gathers at once: two a team of four lanes


def backward_splits(B: int, L: int, n_sm: int, clusters: Callable[[int], int]) -> int:
    """CTAs a user that the backward launches at tau <= 4 (a thread-block
    cluster that shares one multicast copy of the user's dT and R): as many
    as put two CTAs on each of the ``n_sm`` SMs, at most
    ``BWD_MAX_CLUSTER`` and one a 32 rows, at least one, shrunk to the
    largest cluster whose B copies all fit the card at once (kept where
    none does; each row's gradient does not depend on it).
    ``clusters(S)``: the clusters of S CTAs the card holds at once
    (``launch_splits`` asks the card)."""
    S = max(1, min(BWD_MAX_CLUSTER, -(-2 * n_sm // max(B, 1)), -(-L // 32)))
    for s in range(S, 1, -1):
        if B <= clusters(s):
            return s
    return S


def launch_splits(B: int, L: int, G: int, d: int, tau: int, seq_dtype: torch.dtype,
                  dev: torch.device) -> int:
    """``backward_splits`` with ``dev``'s SM count and cluster capacity at
    (G, d, tau): the CTAs a user ``bse_encode_backward`` launches there."""
    code = _build.DTYPE_CODES[seq_dtype]
    return backward_splits(
        B, L, _build.sm_count(dev),
        lambda S: _build.clusters("sdim_bse_encode_backward_clusters", dev, code, G, d, tau, S))


BWD_LT_ROUND = 256    # csrc/bse_encode_backward_large_tau.cu kBwdLtThreads: a large-tau backward
                      # CTA's threads, so its round of rows is 256 / row_lanes(L, d)
# the large-tau backward's layouts (csrc/large_tau.cuh kLtBwd*): R in a CTA's
# shared memory and dT gathered from device memory; dT and R both there; neither
LT_BWD_R, LT_BWD_STAGED, LT_BWD_DEVICE = 0, 1, 2
BWD_LT_DEVICE_Q = 4   # kBwdLtDeviceQ: row lanes of the LT_BWD_DEVICE layout


def row_lanes(n: int, d: int) -> int:
    """Lanes a row of the large-tau kernels' hash (``row_lanes`` in
    ``csrc/large_tau.cuh``): eight where all n rows fit one round of 32
    teams, else 1 up to d = 32, 2 up to 64, 4 up to 128."""
    return 8 if n <= 32 else 1 if d <= 32 else 2 if d <= 64 else 4


def encode_backward_large_tau_split(B: int, L: int, d: int, n_sm: int,
                                    ctas: Callable[[int], int]) -> tuple[int, int]:
    """(layout, S) of the large-tau backward (``csrc/bse_encode_backward_large_tau.cu``):
    ``LT_BWD_STAGED`` (True) where a CTA holds the user's whole dT beside R
    and a round's bucket ids (``ctas(True)`` > 0), else ``LT_BWD_R`` (False:
    each row's G rows of dT gathered from device memory) where R and a
    round's ids fit (``ctas(False)`` > 0), else ``LT_BWD_DEVICE`` (R read
    from device memory too, ``BWD_LT_DEVICE_Q`` lanes a row); and S CTAs a
    user, each a chunk of its rows: as many as the ``n_sm`` SMs hold in one
    wave (``ctas(layout)`` a SM), at most one a round of ``BWD_LT_ROUND``
    / lanes rows (``row_lanes(L, d)``), at least one. ``ctas(layout)``: the
    CTAs an SM holds at once (``launch_large_tau_split`` asks the card; 0
    where a CTA's shared memory does not fit)."""
    lanes = row_lanes(L, d)
    if ctas(True) > 0:
        layout = True
    elif ctas(False) > 0:
        layout = False
    else:
        layout, lanes = LT_BWD_DEVICE, BWD_LT_DEVICE_Q
    per_sm = ctas(layout)
    rounds = -(-L // (BWD_LT_ROUND // lanes))
    return layout, max(1, min(rounds, n_sm * per_sm // max(B, 1)))


def launch_large_tau_split(B: int, L: int, G: int, d: int, tau: int, seq_dtype: torch.dtype,
                           dev: torch.device) -> tuple[int, int]:
    """``encode_backward_large_tau_split`` with ``dev``'s SM count and
    capacity at (G, d, tau, L): the layout and CTAs a user
    ``bse_encode_backward`` launches there at tau 5..10."""
    code = _build.DTYPE_CODES[seq_dtype]
    fit = lambda layout: _build.clusters("sdim_bse_encode_backward_large_tau_ctas", dev, code,
                                         G, d, tau, L, int(layout))
    return encode_backward_large_tau_split(B, L, d, _build.sm_count(dev), fit)


def bse_encode_backward(dT: torch.Tensor, seq: torch.Tensor, mask: torch.Tensor,
                        R: torch.Tensor, tau: int) -> torch.Tensor:
    """Gradient of ``bse_encode`` in seq: dT (B, G, U, d) fp32 -> d seq
    (B, L, d) in seq's dtype."""
    if seq.device.type == "cpu":
        return bse_encode_backward_ref(dT, seq, mask, R, tau)
    return bse_encode_backward_cuda(dT, seq, mask, R, tau)


def bse_encode_backward_cuda(dT: torch.Tensor, seq: torch.Tensor, mask: torch.Tensor,
                             R: torch.Tensor, tau: int, splits: Optional[int] = None,
                             staged: Optional[int] = None) -> torch.Tensor:
    """The kernel launch of ``bse_encode_backward`` with ``splits`` CTAs a
    user, each a chunk of its rows: 1..8 at tau <= 4 (None:
    ``launch_splits`` for this device), 1..L at tau 5..10, where ``staged``
    is the layout (True / ``LT_BWD_STAGED``: the user's dT copied into a
    CTA's shared memory; False / ``LT_BWD_R``: R only; ``LT_BWD_DEVICE``:
    neither; None for either: ``launch_large_tau_split``)."""
    B, L, d = seq.shape
    m = R.shape[0]
    G, U = m // tau, 1 << tau
    if (m % tau or R.shape != (m, d) or mask.shape != (B, L)
            or dT.shape != (B, G, U, d)):
        raise ValueError(f"bse_encode_backward: shapes dT {tuple(dT.shape)} seq "
                         f"{tuple(seq.shape)} mask {tuple(mask.shape)} R {tuple(R.shape)} "
                         f"tau {tau}")
    if not 1 <= tau <= MAX_TAU or d % 4 or d > 128:
        raise ValueError(f"bse_encode_backward: the kernel takes tau 1..{MAX_TAU} and d a "
                         f"multiple of 4 up to 128; got tau {tau}, d {d}")
    code = _build.dtype_code("bse_encode_backward", seq, (torch.float32, torch.bfloat16))
    for name, t in (("dT", dT), ("mask", mask), ("R", R)):
        if t.dtype != torch.float32:
            raise TypeError(f"bse_encode_backward: {name} must be float32")
    dev = _build.require_cuda("bse_encode_backward", dT, seq, mask, R)
    _build.require_aligned("bse_encode_backward", dT, seq, R)
    if tau <= 4:
        if splits is None:
            splits = launch_splits(B, L, G, d, tau, seq.dtype, dev)
        if not 1 <= splits <= BWD_MAX_CLUSTER:
            raise ValueError(f"bse_encode_backward: {splits} CTAs a user; the kernel's cluster "
                             f"takes 1..{BWD_MAX_CLUSTER}")
    out = torch.empty_like(seq)
    if B == 0 or L == 0:
        return out
    if tau > 4:
        if splits is None or staged is None:
            fits, S = launch_large_tau_split(B, L, G, d, tau, seq.dtype, dev)
            staged = fits if staged is None else staged
            splits = S if splits is None else splits
        if not 1 <= splits <= L:
            raise ValueError(f"bse_encode_backward: {splits} CTAs a user of {L} rows")
        if int(staged) not in (LT_BWD_R, LT_BWD_STAGED, LT_BWD_DEVICE):
            raise ValueError(f"bse_encode_backward: layout {staged} (takes {LT_BWD_R}, "
                             f"{LT_BWD_STAGED}, {LT_BWD_DEVICE})")
    lib = _build.load()
    with _build.on_device(dev):
        err = lib.sdim_bse_encode_backward(dT.data_ptr(), seq.data_ptr(), code, mask.data_ptr(),
                                           R.data_ptr(), out.data_ptr(), B, L, G, U, d, m, tau,
                                           splits, int(staged or 0), _build.stream(dev))
    _build.check(err, "bse_encode_backward")
    bse_encode_backward.launches += 1
    return out


bse_encode_backward.launches = 0
