"""Port parity past the register widths: the decoupled deployment's four
kernels (bse_encode, sdim_update, sdim_fused_serve, sdim_query) at d > 128
and where the fused read's shared memory does not fit a CTA.

- The plain versions of the four against the JAX package's Pallas kernels
  in interpret mode (as tests/test_torch_kernels.py runs them) at d = 132
  and 256, tau 3, 4, 5 and 10, and of the two reads at m = 500, d = 128,
  tau = 4 (R alone 256,000 B), on margin-screened inputs.
- The decoupled server of ``sdim-paper`` SMOKE with ``embed_dim = 128``
  (d = 256), unfused and fused, through both packages' ``CTRServer`` on the
  same weights, requests, histories and events.
- The CUDA kernels' choices, which are pure functions, emulated on the CPU
  at the H100's 232,448 bytes of opt-in shared memory a CTA
  (``sdim_query.query_plan``: the fused body, the wide path, the wide path
  with R read from device memory, and its chunks of groups;
  ``gather_shape_wide``; the lists' group slices at d > 128,
  ``encode_large_tau_splits``), and the wide path's chunked sums, the
  large-tau gather's and the lists' encode and fold emulated in numpy at
  d = 256 against the JAX package.

Tolerances: fp32 atol 1e-5 / rtol 1e-5 (the same sums in another order;
the server's scores atol 1e-5 / rtol 1e-4 through its MLP, as
tests/test_torch_serving.py), bse_encode atol 1e-4 (sums of up to L rows,
as tests/test_torch_cuda.py ATOMIC); the chunked wide sums against the
unchunked ones bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import sdim_paper as jcfgs
from repro.kernels.sdim_bucket.ref import bse_encode_ref as jbse_encode_ref
from repro.kernels.sdim_bucket.sdim_bucket import bse_encode as jbse_encode
from repro.kernels.sdim_fused_serve.ref import sdim_fused_serve_ref as jsdim_fused_serve_ref
from repro.kernels.sdim_fused_serve.sdim_fused_serve import \
    sdim_fused_serve as jsdim_fused_serve
from repro.kernels.sdim_query.ref import sdim_query_ref as jsdim_query_ref
from repro.kernels.sdim_query.sdim_query import sdim_query as jsdim_query
from repro.kernels.sdim_update.sdim_update import sdim_update as jsdim_update
from repro.models.ctr import CTRModel as JCTRModel
from repro.serve import quant as jquant
from repro.serve.ctr_server import CTRServer as JCTRServer
from repro_torch.configs import sdim_paper
from repro_torch.kernels.screen import clears_margin, screened_normal
from repro_torch.kernels.sdim_bucket.sdim_bucket import (MAX_REG_D, bse_encode_ref,
                                                         encode_large_tau_splits, encode_path)
from repro_torch.kernels.sdim_fused_serve.sdim_fused_serve import (
    GATHER_WIDE_SMEM, gather_large_tau_smem, gather_shape_wide, sdim_fused_serve_ref)
from repro_torch.kernels.sdim_query.sdim_query import (fused_smem, query_plan, sdim_query_ref,
                                                       wide_smem)
from repro_torch.kernels.sdim_serve.sdim_serve import gather_shape
from repro_torch.kernels.sdim_update.sdim_update import sdim_update_ref, update_path
from repro_torch.models.ctr import CTRModel
from repro_torch.serve.ctr_server import CTRServer
from test_torch_fold_schedules import _check_fold
from torch_schedules import (SMEM_OPTIN, _warp_dot, _warp_sum_of_squares,
                             encode_large_tau_schedule, fused_serve_large_tau_schedule)

FP32 = dict(atol=1e-5, rtol=1e-5)
ENCODE = dict(atol=1e-4, rtol=1e-5)
WIRE32 = dict(atol=1e-5, rtol=1e-4)
WIDE_TAUS = [(3, 48), (4, 48), (5, 45), (10, 40)]   # (tau, m)


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _quantized(rows, name):
    """A store of ``rows`` in ``name`` ("fp32" or "int8") for both
    packages: (port store, port scales, JAX store, JAX scales)."""
    if name == "fp32":
        return _t(rows), None, jnp.asarray(rows), None
    jstore, jscales = jquant.quantize_rows(jnp.asarray(rows), dtype=jquant.TABLE_DTYPES[name])
    store = _t(np.asarray(jstore).view(np.uint8)).view(torch.int8)
    return store, _t(np.asarray(jscales)), jstore, jscales


def _reads_match_pallas(q, rows, slots, present, R, tau):
    """sdim_query_ref off the fetched rows and sdim_fused_serve_ref off an
    fp32 and an int8 store against the Pallas kernels (interpret mode)."""
    table = rows[slots]
    out = sdim_query_ref(_t(q), _t(table), _t(R), tau)
    ref = jsdim_query(jnp.asarray(q), jnp.asarray(table), jnp.asarray(R), tau, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FP32)
    for name in ("fp32", "int8"):
        store, scales, jstore, jscales = _quantized(rows, name)
        out = sdim_fused_serve_ref(store, _t(slots), _t(q), _t(R), tau, scales=scales,
                                   present=_t(present))
        ref = jsdim_fused_serve(jstore, jnp.asarray(slots), jnp.asarray(q), jnp.asarray(R), tau,
                                scales=jscales, present=jnp.asarray(present), interpret=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FP32)
        assert not out[present == 0].any()


@pytest.mark.parametrize("d", [132, 256])
@pytest.mark.parametrize("tau, m", WIDE_TAUS)
def test_plain_kernels_match_pallas_at_wide_rows(tau, m, d):
    """bse_encode (a fully masked user), an sdim_update fold (a duplicate
    slot, a zero-mask row) and both reads of the folded store: the plain
    versions against the Pallas kernels."""
    B, L, C, E = 2, 24, 6, 5
    G, U = m // tau, 1 << tau
    rng = np.random.default_rng(d + tau)
    R = rng.standard_normal((m, d)).astype(np.float32)
    seq = screened_normal(rng, (B, L, d), R)
    mask = (rng.random((B, L)) > 0.25).astype(np.float32)
    mask[-1] = 0.0
    table = bse_encode_ref(_t(seq), _t(mask), _t(R), tau)
    ref = jbse_encode(jnp.asarray(seq), jnp.asarray(mask), jnp.asarray(R), tau, block_l=8,
                      interpret=True)
    np.testing.assert_allclose(table.numpy(), np.asarray(ref), **ENCODE)
    assert not table[-1].any()
    N = B + 2
    store = rng.standard_normal((N, G, U, d)).astype(np.float32)
    slots = np.array([3, 1], np.int32)
    store[slots] = table.numpy()
    events = screened_normal(rng, (3, E, d), R)
    ev_mask = (rng.random((3, E)) > 0.2).astype(np.float32)
    ev_mask[1] = 0.0
    ev_slots = np.array([1, 0, 1], np.int32)          # slot 1 twice; slot 0 new
    folded = sdim_update_ref(_t(store.copy()), _t(ev_slots), _t(events), _t(ev_mask), _t(R), tau)
    ref = jsdim_update(jnp.asarray(store), jnp.asarray(ev_slots), jnp.asarray(events),
                       jnp.asarray(ev_mask), jnp.asarray(R), tau, block_e=8, interpret=True)
    np.testing.assert_allclose(folded.numpy(), np.asarray(ref), **FP32)
    q = screened_normal(rng, (B, C, d), R)
    _reads_match_pallas(q, folded.numpy(), slots, np.array([1, 0], np.float32), R, tau)


def test_plain_reads_match_pallas_past_the_fused_body():
    """sdim_query and sdim_fused_serve at m = 500, d = 128, tau = 4 (R alone
    256,000 B, past a CTA's shared memory on the H100): the plain versions
    against the Pallas kernels."""
    m, tau, d, B, C = 500, 4, 128, 2, 5
    G, U = m // tau, 1 << tau
    rng = np.random.default_rng(500)
    R = rng.standard_normal((m, d)).astype(np.float32)
    q = screened_normal(rng, (B, C, d), R)
    rows = rng.standard_normal((B + 1, G, U, d)).astype(np.float32)
    rows[:, :, 1] = 0.0                                   # empty buckets
    _reads_match_pallas(q, rows, np.array([2, 0], np.int32), np.array([1, 0], np.float32), R,
                        tau)


# ---------------------------------------------------------------------------
# the decoupled server at d = 256
# ---------------------------------------------------------------------------
N_USERS, C, E = 4, 8, 3


def _wide(cfg):
    return dataclasses.replace(cfg, embed_dim=128)


@pytest.fixture(scope="module")
def jax_wide():
    cfg = _wide(jcfgs.SMOKE)
    cfg = dataclasses.replace(cfg, interest=dataclasses.replace(cfg.interest, backend="xla"))
    model = JCTRModel(cfg)
    params = model.init(jax.random.PRNGKey(0))
    return model, params, jax.tree_util.tree_map(np.asarray, params)


def _screened_ids(rng, shape, params_np, cfg):
    """(items, cats) ids whose behavior embeddings clear the hash margin."""
    R = params_np["interest"]["buffers"]["R"]
    items = rng.integers(0, cfg.n_items, shape)
    cats = rng.integers(0, cfg.n_cats, shape)
    while True:
        x = np.concatenate([params_np["item_emb"]["table"][items],
                            params_np["cat_emb"]["table"][cats]], axis=-1)
        bad = ~clears_margin(x, R)
        if not bad.any():
            return items.astype(np.int32), cats.astype(np.int32)
        items[bad] = rng.integers(0, cfg.n_items, int(bad.sum()))
        cats[bad] = rng.integers(0, cfg.n_cats, int(bad.sum()))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_decoupled_server_at_d256_matches_jax(jax_wide, fused):
    """sdim-paper SMOKE with embed_dim = 128 (d = 256) served decoupled with
    an fp32 wire and store, then an event fold and the same requests again,
    through both packages on the same weights."""
    jmodel, jparams, params_np = jax_wide
    cfg = _wide(sdim_paper.SMOKE)
    assert cfg.behavior_dim == 256
    rng = np.random.default_rng(7)
    L = cfg.long_len
    hi, hc = _screened_ids(rng, (N_USERS, L), params_np, cfg)
    mask = (np.arange(L)[None] >= L - rng.integers(L // 4, L + 1, N_USERS)[:, None])
    ci, cc = _screened_ids(rng, (N_USERS, C), params_np, cfg)
    ctx = rng.integers(0, 2, (N_USERS, C, cfg.ctx_dim)).astype(np.float32)
    requests = [(f"u{u}", {"hist_items": hi[u:u + 1], "hist_cats": hc[u:u + 1],
                           "hist_mask": mask[u:u + 1].astype(np.float32)}, ci[u], cc[u], ctx[u])
                for u in range(N_USERS)]
    ei, ec = _screened_ids(rng, (3, E), params_np, cfg)
    events = (["u0", "u2", "u2"], ei, ec, (rng.random((3, E)) > 0.3).astype(np.float32))
    jserver = JCTRServer.build(jmodel, jparams, "decoupled", wire_dtype=jnp.float32,
                               fused=fused)
    server = CTRServer.build(CTRModel(cfg, device="cpu"), params_np, "decoupled",
                             wire_dtype=torch.float32, fused=fused, device="cpu")
    scores = {}
    for name, srv in (("port", server), ("jax", jserver)):
        first = srv.handle_requests(requests)
        srv.bse.ingest_events(*events)
        scores[name] = (first, srv.handle_requests(requests))
    for ours, ref in zip(scores["port"], scores["jax"]):
        assert len(ours) == len(ref) == N_USERS
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a, np.asarray(b), **WIRE32)
    assert server.bse.table_bytes() == jserver.bse.table_bytes()


# ---------------------------------------------------------------------------
# the kernels' choices at the H100's opt-in shared memory, and their sums
# ---------------------------------------------------------------------------
# (m, tau, d, the plan): the fused body, the wide path with R staged, with R
# read from device memory, and in chunks of groups
PLANS = [(48, 3, 128, ("fused", 16, True)), (48, 3, 256, ("fused", 16, True)),
         (48, 4, 256, ("wide", 12, True)), (48, 3, 512, ("wide", 16, True)),
         (500, 4, 128, ("wide", 125, False)), (500, 4, 256, ("wide", 74, False)),
         (48, 4, 132, ("fused", 12, True)), (40, 4, 4096, ("wide", 4, False))]


@pytest.mark.parametrize("m, tau, d, plan", PLANS)
def test_query_plan_on_the_h100(m, tau, d, plan):
    """query_plan at 232,448 bytes: the fused body where its layout fits,
    else the wide path with R staged where it fits beside one candidate and
    one group's rows, and the most groups a chunk that fit; the same body
    for fp32, bf16 and int8 tables (sdim_query and sdim_fused_serve take one
    body at a shape)."""
    G, U = m // tau, 1 << tau
    assert query_plan(G, U, d, m, 4, SMEM_OPTIN) == plan
    for elem in (2, 1):
        assert query_plan(G, U, d, m, elem, SMEM_OPTIN)[0] == plan[0]
    body, gc, r_staged = plan
    assert (fused_smem(G, U, d, m) <= SMEM_OPTIN) == (body == "fused")
    if body == "wide":
        assert wide_smem(G, d, m, 1, 4, gc, r_staged) <= SMEM_OPTIN
        assert gc == G or wide_smem(G, d, m, 1, 4, gc + 1, r_staged) > SMEM_OPTIN
        assert r_staged == (wide_smem(G, d, m, 1, 4, 1, True) <= SMEM_OPTIN)


@pytest.mark.parametrize("m, tau", [(12, 2), (48, 3), (48, 4), (500, 4), (1000, 4), (120, 1)])
def test_query_plan_takes_every_width(m, tau):
    """Every d a multiple of 4 up to 4,096 gets a body whose shared memory
    fits a CTA in every table dtype: no shape the Pallas kernel takes
    reaches a launch the card refuses."""
    G, U = m // tau, 1 << tau
    for d in range(4, 4097, 4):
        for elem in (4, 2, 1):
            body, gc, r_staged = query_plan(G, U, d, m, elem, SMEM_OPTIN)
            smem = (fused_smem(G, U, d, m) if body == "fused"
                    else wide_smem(G, d, m, 1, elem, gc, r_staged))
            assert smem <= SMEM_OPTIN and 1 <= gc <= G


def wide_schedule(store, scales, slots, present, q, R, tau, gc):
    """wide_query.cuh in numpy fp32 with ``gc`` groups a chunk: a warp a
    projection row (``_warp_dot``), the signatures; for each candidate
    the chunks in turn, a warp a selected row's norm of the row times its
    scale (``_warp_sum_of_squares``) and the row over it (times 1 / n);
    the chunk's rows added in g order to the running sum, which the next
    chunk continues (from the answer's row); after the last chunk / G *
    present. An absent user reads no row."""
    B, C, d = q.shape
    G, U = R.shape[0] // tau, 1 << tau
    proj = _warp_dot(q.reshape(B * C, 1, d), R[None])           # (B * C, m)
    bits = (proj.reshape(B, C, G, tau) >= 0).astype(np.int64)
    sig = (bits << np.arange(tau)).sum(-1)                       # (B, C, G)
    out = np.zeros((B, C, d), np.float32)
    for b in range(B):
        if present[b] == 0:
            continue
        for c in range(C):
            acc = np.zeros(d, np.float32)
            for g0 in range(0, G, gc):
                g = np.arange(g0, min(G, g0 + gc))
                rows = store[slots[b], g, sig[b, c, g]].astype(np.float32)
                if scales is not None:
                    rows = rows * scales[slots[b], g, sig[b, c, g]][:, None]
                inv = np.float32(1) / np.sqrt(_warp_sum_of_squares(rows) + np.float32(1e-12))
                for row in rows * inv[:, None]:                 # g order
                    acc = acc + row
            out[b, c] = acc / np.float32(G) * present[b]
    return out


@pytest.mark.parametrize("m, tau, d", [(500, 4, 128), (500, 4, 256), (48, 4, 256)])
def test_wide_schedule_in_chunks_matches_jax(m, tau, d):
    """The wide path at its plan's chunk of groups gives the one-chunk sums
    bit for bit (the running sum carried in the answer's row adds the rows
    in g order from +0), for the fetched read and the store read (int8
    scales, an absent user), within FP32 of the JAX package."""
    G, U = m // tau, 1 << tau
    _, gc, _ = query_plan(G, U, d, m, 4, SMEM_OPTIN)
    rng = np.random.default_rng(m * d)
    R = rng.standard_normal((m, d)).astype(np.float32)
    q = screened_normal(rng, (2, 3, d), R)
    rows = rng.standard_normal((3, G, U, d)).astype(np.float32)
    rows[:, :, 0] = 0.0
    slots, ones = np.array([2, 0], np.int32), np.ones(2, np.float32)
    for g in (gc, max(1, gc // 3)):
        out = wide_schedule(rows, None, slots, ones, q, R, tau, g)
        np.testing.assert_array_equal(out, wide_schedule(rows, None, slots, ones, q, R, tau, G))
    ref = jsdim_query_ref(jnp.asarray(q), jnp.asarray(rows[slots]), jnp.asarray(R), tau)
    np.testing.assert_allclose(out, np.asarray(ref), **FP32)
    jstore, jscales = jquant.quantize_rows(jnp.asarray(rows), dtype=jnp.int8)
    store, scales = np.asarray(jstore), np.asarray(jscales)
    present = np.array([1, 0], np.float32)
    out = wide_schedule(store, scales, slots, present, q, R, tau, gc)
    ref = jsdim_fused_serve_ref(jstore, jnp.asarray(slots), jnp.asarray(q), jnp.asarray(R), tau,
                                scales=jscales, present=jnp.asarray(present))
    np.testing.assert_allclose(out, np.asarray(ref), **FP32)
    assert not out[1].any()


@pytest.mark.parametrize("B, C, G, d, want", [
    (16, 128, 9, 256, (7, 9)),     # a 16-user burst at tau = 5: gather_shape's, 77 KB
    (16, 128, 4, 256, (8, 4)),     # at tau = 10
    (2, 70, 9, 132, (1, 9)),
    (1, 1, 4, 4096, (1, 4)),       # 96 KB exactly
    (1, 1, 40, 8192, (1, 1)),      # the teams halved from 40 to 1
    (16, 128, 9, 1024, (1, 9)),    # the candidates halved from 7 to 1
])
def test_gather_shape_wide(B, C, G, d, want):
    """gather_shape_wide: gather_shape's candidates halved, then its teams,
    until the CTA's rows, candidates and running sums fit
    GATHER_WIDE_SMEM; at any d where one team of one candidate fits."""
    cands, teams = gather_shape(B, C, G, n_sm=132)
    got = gather_shape_wide(cands, teams, d)
    assert got == want
    assert gather_large_tau_smem(*got, d, True) <= GATHER_WIDE_SMEM or got == (1, 1)


@pytest.mark.parametrize("tau, m", [(5, 45), (10, 40)])
def test_wide_gather_schedule_matches_jax(tau, m):
    """sdim_fused_serve's large-tau gather at d = 256 (its WIDE variant:
    the same rows over their norms added in g order at any teams) against
    the JAX package, int8 scales and an absent user."""
    d, G, U = 256, m // tau, 1 << tau
    rng = np.random.default_rng(tau)
    R = rng.standard_normal((m, d)).astype(np.float32)
    q = screened_normal(rng, (2, 5, d), R)
    rows = rng.standard_normal((3, G, U, d)).astype(np.float32)
    jstore, jscales = jquant.quantize_rows(jnp.asarray(rows), dtype=jnp.int8)
    slots, present = np.array([1, 2], np.int32), np.array([1, 0], np.float32)
    out = fused_serve_large_tau_schedule(np.asarray(jstore), np.asarray(jscales), slots, present,
                                         q, R, tau)
    ref = jsdim_fused_serve_ref(jstore, jnp.asarray(slots), jnp.asarray(q), jnp.asarray(R), tau,
                                scales=jscales, present=jnp.asarray(present))
    np.testing.assert_allclose(out, np.asarray(ref), **FP32)


@pytest.mark.parametrize("tau, m", WIDE_TAUS)
def test_wide_lists_encode_and_fold_match_jax(tau, m):
    """At d = 256 both lists paths take every tau (``encode_path``,
    ``update_path``), R out of the group slices' budget (more groups a CTA
    than at d = 128), and their emulations (every cell's rows added in l
    order from +0; the fold's cells from the stored cell in (b, e) order)
    agree with the JAX package."""
    d, G, U = 256, m // tau, 1 << tau
    assert encode_path(d, tau) == update_path(d, tau) == "lists" and d > MAX_REG_D
    assert encode_path(MAX_REG_D, tau) == update_path(MAX_REG_D, tau) == (
        "groups" if tau <= 4 else "lists")
    Gs, _, _ = encode_large_tau_splits(16, G, U, 1024, d, tau, 132)
    assert Gs >= encode_large_tau_splits(16, G, U, 1024, 128, tau, 132)[0]
    rng = np.random.default_rng(11 + tau)
    R = rng.standard_normal((m, d)).astype(np.float32)
    seq = screened_normal(rng, (2, 40, d), R)
    mask = (rng.random((2, 40)) > 0.3).astype(np.float32)
    table, writes, _ = encode_large_tau_schedule(seq, mask, R, tau)
    assert (writes == 1).all()
    ref = np.asarray(jbse_encode_ref(jnp.asarray(seq), jnp.asarray(mask), jnp.asarray(R), tau))
    np.testing.assert_allclose(table, ref, **ENCODE)
    store = rng.standard_normal((4, G, U, d)).astype(np.float32)
    store[[1, 3]] = table
    events = screened_normal(rng, (3, 4, d), R)
    ev_mask = (rng.random((3, 4)) > 0.25).astype(np.float32)
    ev_mask[2] = 0.0
    _check_fold(store, np.array([3, 0, 3], np.int32), events, ev_mask, R, tau)
