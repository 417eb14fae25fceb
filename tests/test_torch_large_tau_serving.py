"""Port parity, serving at tau 5..10: the plain versions of the three
serving kernels whose large-tau paths run on the card (``sdim_update``,
``sdim_fused_serve`` off fp32, bf16, int8 and fp8 stores, ``bse_serve``,
also at tau = 1 with G = 48) against the JAX package's ``SDIMEngine`` at
``backend="pallas"`` (its Pallas kernels in interpret mode), and the slice
as a whole: ``sdim-paper`` SMOKE with interest tau = 5 (m = 10) and tau =
10 (m = 20), built as ``benchmarks/table4_tau.py`` builds it
(``dataclasses.replace``), served decoupled (fused and fetch) and inline
through the port's ``BSEServer`` + ``CTRServer`` and the JAX package's,
on the JAX init carried across by ``load_jax_params``; plus the analytical
counts of ``kernels/cost.py`` on the large-tau paths.

At tau = 10 a random candidate almost always selects an empty bucket (1,024
a group), and a test of all-zero interest checks nothing: half of each
user's candidates are drawn from the user's own valid behaviors, every
hashed row is margin-screened (``kernels.screen``), and each test asserts
the share of output rows that are nonzero.

Tolerances: fp32 atol 1e-5 / rtol 1e-5 per module (the same sums in
another order); bf16 behaviors rtol 2e-2 / atol 1e-2 (tests/test_kernels.py:
46-47); the slice atol 1e-5 / rtol 1e-4 with an fp32 wire, as
tests/test_torch_serving.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import sdim_paper as jcfgs
from repro.core.engine import EngineConfig, SDIMEngine as JSDIMEngine
from repro.models.ctr import CTRModel as JCTRModel
from repro.serve import quant as jquant
from repro.serve.ctr_server import CTRServer as JCTRServer
from repro_torch.configs import sdim_paper
from repro_torch.kernels import cost
from repro_torch.kernels.screen import clears_margin, screened_normal
from repro_torch.kernels.sdim_fused_serve.sdim_fused_serve import (sdim_fused_serve,
                                                                   sdim_fused_serve_ref)
from repro_torch.kernels.sdim_serve.sdim_serve import (bse_serve, bse_serve_ref,
                                                       cluster_body_takes,
                                                       serve_large_tau_work_floats)
from repro_torch.kernels.sdim_update.sdim_update import sdim_update, sdim_update_ref
from repro_torch.models.ctr import CTRModel
from repro_torch.serve.ctr_server import CTRServer

FP32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=1e-2, rtol=2e-2)
WIRE32 = dict(atol=1e-5, rtol=1e-4)
LARGE = [(5, 10), (7, 14), (10, 20)]        # (tau, m): G = 2
WIDTHS = [16, 36]


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _jengine(m, tau, d):
    return JSDIMEngine(EngineConfig(m=m, tau=tau, d=d, backend="pallas", block_l=32,
                                    block_c=16, interpret=True))


def _nonzero_share(out):
    """The share of (user, candidate) rows of ``out`` (B, C, d) that are not
    all zero."""
    return float(np.abs(out).sum(-1).astype(bool).mean())


def _serve_inputs(rng, B, L, C, d, R, dtype=torch.float32):
    """Screened behaviors and candidates, the last user fully masked, and
    half of every other user's candidates copies of its own valid behaviors
    (the values as ``dtype`` stores them)."""
    seq = screened_normal(rng, (B, L, d), R, dtype)
    q = screened_normal(rng, (B, C, d), R)
    mask = (rng.random((B, L)) > 0.25).astype(np.float32)
    mask[-1] = 0.0
    for b in range(B - 1):
        valid = np.flatnonzero(mask[b])
        q[b, :C // 2] = seq[b, rng.choice(valid, C // 2)]
    return seq, q, mask


@pytest.mark.parametrize("tau, m, d", [(t, m, d) for t, m in LARGE for d in WIDTHS]
                         + [(1, 48, 128)],
                         ids=[f"tau{t}-{d}" for t, _ in LARGE for d in WIDTHS] + ["tau1-G48-128"])
def test_bse_serve_large_tau_matches_jax(tau, m, d):
    """bse_serve's plain version against the JAX engine's serve (Pallas
    bse_serve in interpret mode) where the card runs the large-tau path
    (tau 5..10; tau = 1 at G = 48 and d = 128, beyond the cluster body's
    registers); bf16 behaviors too, except at d = 36."""
    B, L, C = 3, 40, 8
    assert not cluster_body_takes(m // tau, d, tau)
    rng = np.random.default_rng(100 + tau + d)
    R = rng.standard_normal((m, d)).astype(np.float32)
    for tdt, jdt, tol in ((torch.float32, jnp.float32, FP32),
                          (torch.bfloat16, jnp.bfloat16, BF16))[:1 if d == 36 else 2]:
        seq, q, mask = _serve_inputs(rng, B, L, C, d, R, tdt)
        out = bse_serve_ref(_t(q), _t(seq, tdt), _t(mask), _t(R), tau).numpy()
        ref = np.asarray(_jengine(m, tau, d).serve(jnp.asarray(q), jnp.asarray(seq, jdt),
                                                   jnp.asarray(mask), R=jnp.asarray(R)),
                         np.float32)
        assert out.shape == (B, C, d)
        np.testing.assert_allclose(out, ref, **tol)
        assert not out[-1].any()                  # the fully masked user
        assert _nonzero_share(out[:-1]) >= 0.5    # its own behaviors select nonempty buckets


@pytest.mark.parametrize("store_dtype", ["fp32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("tau, m", LARGE, ids=["tau5", "tau7", "tau10"])
def test_sdim_fused_serve_large_tau_matches_jax(tau, m, d, store_dtype):
    """sdim_fused_serve's plain version against the JAX engine's serve_fused
    (Pallas, interpret mode) off a store of users' encoded histories plus
    random rows, in four storage types with per-row scales; an absent user
    and a zero row read zero."""
    B, L, C = 4, 40, 8
    G, U = m // tau, 1 << tau
    rng = np.random.default_rng(200 + tau + d)
    R = rng.standard_normal((m, d)).astype(np.float32)
    seq, q, mask = _serve_inputs(rng, B, L, C, d, R)
    N = 2 * B + 1
    rows = rng.standard_normal((N, G, U, d)).astype(np.float32)
    rows *= rng.uniform(0.1, 10.0, (N, G, U, 1)).astype(np.float32)
    rows[0] = 0.0                                 # a fully masked user's zero table
    slots = rng.permutation(np.arange(1, N))[:B].astype(np.int32)
    rows[slots[:-1]] = np.asarray(jnp.asarray(
        _jengine(m, tau, d).encode(jnp.asarray(seq[:-1]), jnp.asarray(mask[:-1]),
                                   R=jnp.asarray(R))))          # encoded histories
    slots[-1] = 0
    present = np.ones(B, np.float32)
    present[1] = 0.0                              # an absent user
    jscales = None
    if store_dtype in ("int8", "fp8"):
        jstore, jscales = jquant.quantize_rows(jnp.asarray(rows),
                                               dtype=jquant.TABLE_DTYPES[store_dtype])
    else:
        jstore = jnp.asarray(rows, jnp.bfloat16 if store_dtype == "bf16" else jnp.float32)
    tdt = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8,
           "fp8": torch.float8_e4m3fn}[store_dtype]
    store = torch.from_numpy(np.array(jstore.astype(jnp.float32))).to(tdt)
    scales = None if jscales is None else _t(jscales)
    out = sdim_fused_serve_ref(store, _t(slots), _t(q), _t(R), tau, scales=scales,
                               present=_t(present)).numpy()
    ref = np.asarray(_jengine(m, tau, d).serve_fused(jstore, jnp.asarray(slots), jnp.asarray(q),
                                                     present=jnp.asarray(present),
                                                     scales=jscales, R=jnp.asarray(R)))
    np.testing.assert_allclose(out, ref, **FP32)
    assert not out[1].any() and not out[-1].any()
    assert _nonzero_share(out[[0, 2]]) >= 0.5


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("tau, m", LARGE, ids=["tau5", "tau7", "tau10"])
def test_sdim_update_large_tau_matches_jax(tau, m, d, dtype):
    """sdim_update's plain version against the JAX engine's update (Pallas,
    interpret mode): duplicate slots accumulate in b order, a zero-mask row
    changes nothing, and the cells no weighted event reached keep their
    exact bits."""
    B, E = 6, 5
    G, U = m // tau, 1 << tau
    rng = np.random.default_rng(300 + tau + d)
    R = rng.standard_normal((m, d)).astype(np.float32)
    tdt, jdt = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    events = screened_normal(rng, (B, E, d), R, tdt)
    mask = (rng.random((B, E)) > 0.25).astype(np.float32)
    store = rng.standard_normal((B + 2, G, U, d)).astype(np.float32)
    slots = np.array([0, 3, 1, 3, 2, 1], np.int32)       # 3 and 1 twice
    mask[0] = 0.0                                         # slot 0: a zero-mask row
    out = sdim_update_ref(_t(store), _t(slots), _t(events, tdt), _t(mask), _t(R), tau).numpy()
    ref = np.asarray(_jengine(m, tau, d).update(jnp.asarray(store), jnp.asarray(slots),
                                                jnp.asarray(events, jdt), jnp.asarray(mask),
                                                R=jnp.asarray(R)))
    np.testing.assert_allclose(out, ref, **FP32)
    reached = np.zeros((B + 2, G, U), bool)
    ev = _t(events, tdt).float().numpy()
    proj = np.einsum("bed,md->bem", ev, R).reshape(B, E, G, tau)
    sig = ((proj >= 0) * (1 << np.arange(tau))).sum(-1)   # (B, E, G)
    for b, e in zip(*np.nonzero(mask)):
        reached[slots[b], np.arange(G), sig[b, e]] = True
    assert reached.any(axis=(1, 2))[[1, 2, 3]].all() and not reached[0].any()
    np.testing.assert_array_equal(out[~reached], store[~reached])
    assert (out[reached] != store[reached]).mean() > 0.9  # the folded cells moved


def test_large_tau_wrappers_run_plain_on_cpu_without_counting():
    """On CPU tensors the wrappers run the plain versions at tau 5..10 and
    count no launch (a CUDA tensor launches the kernel or raises)."""
    tau, m, d, B, L, C, E = 10, 20, 16, 2, 12, 4, 3
    rng = np.random.default_rng(7)
    R = rng.standard_normal((m, d)).astype(np.float32)
    seq, q, mask = _serve_inputs(rng, B, L, C, d, R)
    store = _t(rng.standard_normal((3, 2, 1 << tau, d)).astype(np.float32))
    slots = _t(np.array([2, 0], np.int32))
    ev = _t(screened_normal(rng, (B, E, d), R))
    ev_mask = torch.ones((B, E))
    before = (bse_serve.launches, sdim_fused_serve.launches, sdim_update.launches)
    args = (_t(q), _t(seq), _t(mask), _t(R))
    assert torch.equal(bse_serve(*args, tau), bse_serve_ref(*args, tau))
    assert torch.equal(sdim_fused_serve(store, slots, _t(q), _t(R), tau),
                       sdim_fused_serve_ref(store, slots, _t(q), _t(R), tau))
    a, b = store.clone(), store.clone()
    assert sdim_update(a, slots, ev, ev_mask, _t(R), tau) is a
    assert torch.equal(a, sdim_update_ref(b, slots, ev, ev_mask, _t(R), tau))
    assert (bse_serve.launches, sdim_fused_serve.launches, sdim_update.launches) == before


def test_large_tau_costs_count_the_rows_reached():
    """kernels/cost.py on the large-tau paths, by hand: serve_fused reads the
    rows present users' candidates select, update reads and writes the
    cells valid events reach, serve normalizes only the selected rows; the
    scratch of bse_serve's large-tau path holds min(U, C) rows a group."""
    tau, m, d = 5, 10, 16
    G, U = m // tau, 1 << tau
    rng = np.random.default_rng(8)
    R = _t(rng.standard_normal((m, d)).astype(np.float32))
    hash_flops = 2 * m * d + G * d
    x = _t(screened_normal(rng, (1, d), R.numpy()))[0]
    q = torch.stack([x, x, -x])[None].expand(2, 3, d).contiguous()   # 2 distinct rows a group
    store = torch.zeros((4, G, U, d))
    slots = torch.tensor([1, 3], dtype=torch.int32)
    c = cost.settle(cost.serve_fused(store, slots, q, R, tau=tau,
                                     present=torch.tensor([1.0, 0.0])))
    assert c.flops == 3 * hash_flops + 2 * G * 3 * d                # one present user
    assert c.bytes == 2 * G * d * 4 + 3 * d * 4 + q.numel() * 4 + R.numel() * 4 + 2 * 8
    events = torch.stack([x, x, -x])[None].expand(2, 3, d).contiguous()
    mask = torch.tensor([[1.0, 1.0, 0.0], [1.0, 0.0, 0.0]])        # x, x | x: one cell a group
    c = cost.settle(cost.update(store, torch.tensor([1, 1], dtype=torch.int32), events, mask, R,
                                tau=tau))
    assert c.flops == 3 * hash_flops
    assert c.bytes == 2 * G * d * 4 + 3 * d * 4 + mask.numel() * 4 + 2 * 4 + R.numel() * 4
    seq = events
    c = cost.settle(cost.serve(q, seq, mask, R, tau=tau))
    assert c.flops == (3 + 6) * hash_flops + 2 * 2 * G * 3 * d      # 2 rows a (user, group)
    assert serve_large_tau_work_floats(2, 3, G, U, d) == 2 * G * 3 * d + 2 * 3 * G


# ---------------------------------------------------------------------------
# the slice: sdim-paper SMOKE at tau 5 and 10, through both packages' servers
# ---------------------------------------------------------------------------
N_USERS, C, E = 6, 8, 3


def _configs(tau, m):
    jcfg, cfg = jcfgs.SMOKE, sdim_paper.SMOKE
    jcfg = dataclasses.replace(jcfg, interest=dataclasses.replace(
        jcfg.interest, tau=tau, m=m, backend="pallas", interpret=True, block_l=16, block_c=8))
    return jcfg, dataclasses.replace(cfg, interest=dataclasses.replace(cfg.interest, tau=tau,
                                                                       m=m))


def _behaviors(params_np, cfg, items, cats):
    return np.concatenate([params_np["item_emb"]["table"][items % cfg.n_items],
                           params_np["cat_emb"]["table"][cats % cfg.n_cats]], axis=-1)


def _screened_ids(rng, shape, params_np, cfg):
    R = params_np["interest"]["buffers"]["R"]
    items = rng.integers(0, cfg.n_items, shape)
    cats = rng.integers(0, cfg.n_cats, shape)
    while True:
        bad = ~clears_margin(_behaviors(params_np, cfg, items, cats), R)
        if not bad.any():
            return items.astype(np.int32), cats.astype(np.int32)
        items[bad] = rng.integers(0, cfg.n_items, int(bad.sum()))
        cats[bad] = rng.integers(0, cfg.n_cats, int(bad.sum()))


def _traffic(params_np, cfg):
    """Requests whose first half of candidates are the user's own valid
    behaviors, and an event burst in which users 0 and 2 see two of their
    own candidates again (so the fold moves scores at tau = 10 too)."""
    rng = np.random.default_rng(0)
    L = cfg.long_len
    hi, hc = _screened_ids(rng, (N_USERS, L), params_np, cfg)
    lengths = rng.integers(L // 4, L + 1, N_USERS)
    mask = (np.arange(L)[None] >= (L - lengths[:, None])).astype(np.float32)
    ci, cc = _screened_ids(rng, (N_USERS, C), params_np, cfg)
    for u in range(N_USERS):
        own = rng.choice(np.flatnonzero(mask[u]), C // 2)
        ci[u, :C // 2], cc[u, :C // 2] = hi[u, own], hc[u, own]
    ctx = rng.integers(0, 2, (N_USERS, C, cfg.ctx_dim)).astype(np.float32)
    requests = [(f"u{u}", {"hist_items": hi[u:u + 1], "hist_cats": hc[u:u + 1],
                           "hist_mask": mask[u:u + 1]}, ci[u], cc[u], ctx[u])
                for u in range(N_USERS)]
    ev_users = [f"u{u}" for u in (0, 2, 2, 5)]             # a repeated user
    ei, ec = _screened_ids(rng, (len(ev_users), E), params_np, cfg)
    ei[:2, 0], ec[:2, 0] = ci[[0, 2], C // 2], cc[[0, 2], C // 2]
    ev_mask = (rng.random((len(ev_users), E)) > 0.3).astype(np.float32)
    ev_mask[:2, 0] = 1.0
    return requests, (ev_users, ei, ec, ev_mask)


@pytest.fixture(scope="module", params=[(5, 10), (10, 20)], ids=["tau5", "tau10"])
def slice_side(request):
    tau, m = request.param
    jcfg, cfg = _configs(tau, m)
    jmodel = JCTRModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    return cfg, jmodel, jparams, params_np, _traffic(params_np, cfg)


@pytest.mark.parametrize("mode", ["fetch", "fused", "inline"])
def test_large_tau_slice_matches_jax(slice_side, mode):
    """Decoupled (fetch: fetch_many + sdim_query; fused: sdim_fused_serve
    off the fp32 store) and inline (bse_serve) serving of sdim-paper SMOKE at
    tau 5 and 10, the port's servers against the JAX package's over an fp32
    wire: the requests, an event burst (sdim_update into the fp32 store),
    the requests again. The burst moves the scores; decoupled and inline
    agree; half the candidates' interest rows are nonzero."""
    cfg, jmodel, jparams, params_np, (requests, events) = slice_side
    kw = (dict(wire_dtype=jnp.float32, fused=mode == "fused") if mode != "inline" else {})
    jserver = JCTRServer.build(jmodel, jparams, "inline" if mode == "inline" else "decoupled",
                               **kw)
    model = CTRModel(cfg, device="cpu")
    tkw = dict(wire_dtype=torch.float32, fused=mode == "fused") if mode != "inline" else {}
    server = CTRServer.build(model, params_np, "inline" if mode == "inline" else "decoupled",
                             device="cpu", **tkw)
    rounds = []
    for srv in (server, jserver):
        first = srv.handle_requests(requests)
        if mode != "inline":
            srv.bse.ingest_events(*events)
        rounds.append((first, srv.handle_requests(requests)))
    for ours, ref in zip(*rounds):
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a, np.asarray(b), **WIRE32)
    if mode != "inline":
        moved = max(float(np.abs(a - b).max()) for a, b in zip(*rounds[0]))
        assert moved > 1e-4, "the event burst moved no score"
        inline = CTRServer.build(model, params_np, "inline", device="cpu")
        for a, b in zip(inline.handle_requests(requests), rounds[0][0]):
            np.testing.assert_allclose(a, b, **WIRE32)
    # the long branch of the burst: half its rows select a nonempty bucket
    burst = {k: torch.as_tensor(np.concatenate([r[1][k] for r in requests]))
             for k in ("hist_items", "hist_cats", "hist_mask")}
    with torch.no_grad():
        target = model._embed_behaviors(torch.as_tensor(np.stack([r[2] for r in requests])),
                                        torch.as_tensor(np.stack([r[3] for r in requests])))
        long_e = model._embed_behaviors(burst["hist_items"], burst["hist_cats"])
        interest = model.interest(target, long_e, burst["hist_mask"]).numpy()
    assert _nonzero_share(interest) >= 0.5
