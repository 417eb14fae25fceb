"""Port parity, the slice as a whole: decoupled SDIM serving of
``sdim-paper`` (SMOKE) through the JAX package's ``CTRServer`` (XLA
backend) and the port's ``CTRServer`` on the CPU, on the same weights
(``CTRModel(SMOKE).init(PRNGKey(0))`` carried across by
``load_jax_params``) and the same requests, histories and events.

Every behavior, candidate and event embedding that gets hashed is drawn so
that each projection clears 1e-3·‖r‖‖x‖ (the test asserts it), so the two
frameworks agree on every signature bit. Tolerances: atol 1e-5 / rtol 1e-4
with an fp32 wire (the same arithmetic in another order through a three-
layer MLP); rtol/atol 2e-2 with the default bf16 wire.
"""
import dataclasses
import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import sdim_paper as jcfgs
from repro.models.ctr import CTRModel as JCTRModel
from repro.serve.ctr_server import CTRServer as JCTRServer
from repro_torch.configs import sdim_paper
from repro_torch.kernels.screen import clears_margin
from repro_torch.models.ctr import CTRModel
from repro_torch.serve.ctr_server import CTRServer
from repro_torch.weights import load_jax_params

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
N_USERS, C, E = 6, 8, 3
WIRE32 = dict(atol=1e-5, rtol=1e-4)
WIRE16 = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture(scope="module")
def jax_side():
    cfg = jcfgs.SMOKE
    cfg = dataclasses.replace(cfg, interest=dataclasses.replace(cfg.interest, backend="xla"))
    model = JCTRModel(cfg)
    params = model.init(jax.random.PRNGKey(0))
    return model, params, jax.tree_util.tree_map(np.asarray, params)


def _behaviors(params_np, items, cats):
    cfg = sdim_paper.SMOKE
    return np.concatenate([params_np["item_emb"]["table"][items % cfg.n_items],
                           params_np["cat_emb"]["table"][cats % cfg.n_cats]], axis=-1)


def _screened_ids(rng, shape, params_np):
    """(items, cats) ids whose behavior embeddings clear the hash margin."""
    cfg = sdim_paper.SMOKE
    R = params_np["interest"]["buffers"]["R"]
    items = rng.integers(0, cfg.n_items, shape)
    cats = rng.integers(0, cfg.n_cats, shape)
    while True:
        bad = ~clears_margin(_behaviors(params_np, items, cats), R)
        if not bad.any():
            return items.astype(np.int32), cats.astype(np.int32)
        items[bad] = rng.integers(0, cfg.n_items, int(bad.sum()))
        cats[bad] = rng.integers(0, cfg.n_cats, int(bad.sum()))


def _traffic(params_np, seed=0):
    cfg = sdim_paper.SMOKE
    rng = np.random.default_rng(seed)
    L = cfg.long_len
    hi, hc = _screened_ids(rng, (N_USERS, L), params_np)
    lengths = rng.integers(L // 4, L + 1, N_USERS)
    mask = (np.arange(L)[None] >= (L - lengths[:, None])).astype(np.float32)
    ci, cc = _screened_ids(rng, (N_USERS, C), params_np)
    ctx = rng.integers(0, 2, (N_USERS, C, cfg.ctx_dim)).astype(np.float32)
    requests = [(f"u{u}", {"hist_items": hi[u:u + 1], "hist_cats": hc[u:u + 1],
                           "hist_mask": mask[u:u + 1]}, ci[u], cc[u], ctx[u])
                for u in range(N_USERS)]
    ev_users = [f"u{u}" for u in (0, 2, 2, 5)]             # a repeated user
    ei, ec = _screened_ids(rng, (len(ev_users), E), params_np)
    ev_mask = (rng.random((len(ev_users), E)) > 0.3).astype(np.float32)
    R = params_np["interest"]["buffers"]["R"]
    every = np.concatenate([_behaviors(params_np, hi, hc).reshape(-1, sdim_paper.SMOKE.behavior_dim),
                            _behaviors(params_np, ci, cc).reshape(-1, sdim_paper.SMOKE.behavior_dim),
                            _behaviors(params_np, ei, ec).reshape(-1, sdim_paper.SMOKE.behavior_dim)])
    assert clears_margin(every, R).all(), "seed no longer clears the hash margin"
    return requests, (ev_users, ei, ec, ev_mask)


def _serve(server, requests, events):
    first = server.handle_requests(requests)
    server.bse.ingest_events(*events)
    return first, server.handle_requests(requests)


@pytest.mark.parametrize("wire", ["fp32", "bf16"])
@pytest.mark.parametrize("table_dtype", ["fp32", "int8", "fp8"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_handle_requests_match_jax(jax_side, fused, table_dtype, wire):
    jmodel, jparams, params_np = jax_side
    requests, events = _traffic(params_np)
    jwire, twire = {"fp32": (jnp.float32, torch.float32),
                    "bf16": (jnp.bfloat16, torch.bfloat16)}[wire]
    jserver = JCTRServer.build(jmodel, jparams, "decoupled", wire_dtype=jwire,
                               table_dtype=table_dtype, fused=fused)
    model = CTRModel(sdim_paper.SMOKE, device="cpu")
    server = CTRServer.build(model, params_np, "decoupled", wire_dtype=twire,
                             table_dtype=table_dtype, fused=fused, device="cpu")
    tol = WIRE32 if wire == "fp32" else WIRE16
    for ours, ref in zip(_serve(server, requests, events), _serve(jserver, requests, events)):
        assert len(ours) == len(ref) == N_USERS
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a, np.asarray(b), **tol)
    assert server.bse.stats.n_updates == jserver.bse.stats.n_updates
    assert server.bse.stats.bytes_transmitted == jserver.bse.stats.bytes_transmitted
    assert server.bse.table_bytes() == jserver.bse.table_bytes()


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_bf16_store_event_fold_matches_jax(jax_side, fused):
    """A bf16 store folds two event bursts. JAX's fold turns the bf16 store
    into fp32 data (engine.update returns fp32); the port keeps it bf16 and
    folds by encode + read-modify-write. The scores agree at the reference's
    bf16 tolerance (tests/test_kernels.py:46-47)."""
    jmodel, jparams, params_np = jax_side
    requests, events = _traffic(params_np)
    _, later = _traffic(params_np, seed=3)
    jserver = JCTRServer.build(jmodel, jparams, "decoupled", table_dtype="bf16", fused=fused)
    server = CTRServer.build(CTRModel(sdim_paper.SMOKE, device="cpu"), params_np, "decoupled",
                             table_dtype="bf16", fused=fused, device="cpu")
    for srv in (server, jserver):
        srv.handle_requests(requests)
        srv.bse.ingest_events(*events)
        srv.bse.ingest_events(*later)
    assert server.bse.store.data.dtype == torch.bfloat16
    for a, b in zip(server.handle_requests(requests), jserver.handle_requests(requests)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-2, rtol=2e-2)


def test_model_apply_and_encode_match_jax(jax_side):
    """The training forward (interest = query ∘ encode) and the BSE encode
    step, on the same batch."""
    jmodel, jparams, params_np = jax_side
    requests, _ = _traffic(params_np, seed=1)
    hist = {k: np.concatenate([r[1][k] for r in requests])
            for k in ("hist_items", "hist_cats", "hist_mask")}
    batch = dict(hist, cand_item=np.stack([r[2][0] for r in requests]),
                 cand_cat=np.stack([r[3][0] for r in requests]),
                 ctx=np.stack([r[4][0] for r in requests]))
    model = load_jax_params(CTRModel(sdim_paper.SMOKE, device="cpu"), params_np)
    with torch.no_grad():
        logits = model.apply({k: torch.as_tensor(v) for k, v in batch.items()}).numpy()
        tables = model.encode_bse_table({k: torch.as_tensor(v) for k, v in hist.items()})
    ref = jmodel.apply(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(logits, np.asarray(ref), **WIRE32)
    jtables = jmodel.encode_bse_table(jparams, {k: jnp.asarray(v) for k, v in hist.items()})
    np.testing.assert_allclose(tables.numpy(), np.asarray(jtables), atol=1e-6, rtol=1e-5)


def test_miss_contract_and_store_lifecycle(jax_side):
    """Unknown users read as zero rows / zero interest and count as misses;
    slots grow by doubling and are recycled after eviction, as in JAX."""
    jmodel, jparams, params_np = jax_side
    requests, _ = _traffic(params_np)
    model = CTRModel(sdim_paper.SMOKE, device="cpu")
    server = CTRServer.build(model, params_np, capacity=2, device="cpu")
    jserver = JCTRServer.build(jmodel, jparams, "decoupled", capacity=2)
    for srv in (server, jserver):
        srv.handle_requests(requests[:3])
        srv.bse.evict("u1")
        srv.handle_requests(requests[3:])
    bse, jbse = server.bse, jserver.bse
    assert bse.store.capacity == jbse.store.capacity == 8
    assert bse.store.n_grows == jbse.store.n_grows == 2
    assert {u: bse.store.slot(u) for u in bse.store.users()} == \
        {u: jbse.store.slot(u) for u in jbse.store.users()}
    rows = bse.fetch_many(["u0", "nobody"])
    assert not rows[1].any() and bse.stats.n_misses == 1
    q = model._embed_behaviors(torch.as_tensor(requests[0][2][None]),
                               torch.as_tensor(requests[0][3][None]))
    with torch.no_grad():
        out = bse.serve_candidates(["nobody"], q)
    assert not out.any() and bse.stats.n_misses == 2
    assert bse.fetch("nobody") is None and bse.stats.n_misses == 3


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = [os.path.join(dp, f) for dp, _, fs in os.walk(os.path.join(ROOT, "src", "repro_torch"))
             for f in fs if f.endswith(".py")]
    files += [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "phase_clocks.py")]
    assert len(files) > 20
    assert {"profiler.py", "cost.py", "roofline.py", "mesh_ctx.py"} <= \
        {os.path.basename(f) for f in files}
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f} imports {mod}"


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_table_store_write_paths_match_jax(dtype):
    """Quantize-on-write (non-finite rows zeroed and counted), the saturating
    bf16 cast, the raw-byte round trip and clear(), against the JAX store."""
    from repro.serve.table_store import TableStore as JTableStore
    from repro_torch.serve.table_store import TableStore

    rng = np.random.default_rng(5)
    rows = (rng.standard_normal((3, 4, 2, 8)) * 3).astype(np.float32)
    rows[0, 1, 1, 2] = np.nan
    rows[2, 0, 0, 0] = 3.4e38                                 # past bf16's max
    ours, theirs = TableStore(4, 2, 8, capacity=2, dtype=dtype, device="cpu"), \
        JTableStore(4, 2, 8, capacity=2, dtype=dtype)
    with pytest.warns(UserWarning):
        ours.write(ours.assign(["a", "b", "c"]), torch.from_numpy(rows))
    with pytest.warns(UserWarning):
        theirs.write(theirs.assign(["a", "b", "c"]), jnp.asarray(rows))
    slots = ours.slots(["c", "a", "b"])
    np.testing.assert_array_equal(ours.rows(slots).float().numpy(),
                                  np.asarray(theirs.rows(slots)).astype(np.float32))
    assert (ours.n_nonfinite, ours.n_saturated) == (theirs.n_nonfinite, theirs.n_saturated)
    payload, scales = ours.rows_raw(slots)
    copy = TableStore(4, 2, 8, capacity=4, dtype=dtype, device="cpu")
    copy.write_raw(copy.assign(["c", "a", "b"]), payload, scales)
    torch.testing.assert_close(copy.rows(copy.slots(["a", "b", "c"])),
                               ours.rows(ours.slots(["a", "b", "c"])),
                               atol=0, rtol=0, equal_nan=True)    # bit-exact
    ours.clear()
    assert len(ours) == 0 and ours.n_grows == 0 and not ours.data.float().any()
