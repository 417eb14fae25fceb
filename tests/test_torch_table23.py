"""Port parity, the Table 2/3 comparison as a whole: the port's protocol
(``repro_torch.bench``) against ``benchmarks/common.py`` and the JAX CTR
model on the CPU, for every interest kind the comparison trains.

* ``auc`` equals ``benchmarks.common.auc`` on tied scores.
* Five AdamW steps of ``train_and_eval``'s loop (``bench.common.train``)
  from the JAX package's initial parameters (carried by
  ``load_jax_params``) at L = 64, batch 32, against the same steps of
  ``repro.train.loop.make_train_step`` on the same stream: per-step losses
  within fp32 atol 1e-5 / rtol 1e-5, the reference's own tolerance; then
  the eval scores of one batch of 1,024 (``bench.common.evaluate``) on the
  same weights. Kinds ``avg``, ``sim_hard``, ``eta``, ``ubr4ctr``,
  ``din_mlp`` and ``sdim`` (both hash families).
* Every non-sdim kind served by the inline ``CTRServer``, and an ``sdim``
  model of the SRHT family served decoupled, against the JAX servers.

Hashed rows are margin-screened (``kernels.screen``): before training the
item rows that the five batches hash are redrawn until they clear
1e-3·‖r‖‖x‖, and the test asserts, on the JAX parameters before every
step, that they still clear 1e-4·‖r‖‖x‖ (the steps move them a little);
for ``ubr4ctr`` it asserts likewise that each example's k-th and (k+1)-th
retrieval scores are apart by 1e-4 of the largest (``topk_clear``).
The eval batch is screened the same way on the trained port model, whose
weights the JAX model then evaluates.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import common as jcommon
from repro.configs import sdim_paper as jcfgs
from repro.data.pipeline import DeterministicStream as JDeterministicStream
from repro.data.synthetic import generate_batch_graded as jgenerate_batch_graded
from repro.models.ctr import CTRModel as JCTRModel
from repro.serve.ctr_server import CTRServer as JCTRServer
from repro.train import optimizer as jopt
from repro.train.loop import make_train_step as jmake_train_step
from repro_torch.bench import common, table23_auc
from repro_torch.configs import sdim_paper
from repro_torch.data.synthetic import generate_batch_graded
from repro_torch.kernels.screen import (MARGIN, clears_margin, screen_item_rows,
                                        screen_topk_rows, topk_clear, ubr4ctr_scores)
from repro_torch.models.ctr import CTRModel
from repro_torch.serve.ctr_server import CTRServer
from repro_torch.train.optimizer import decay_mask, trainable_mask
from repro_torch.weights import export_params, load_jax_params

FP32 = dict(atol=1e-5, rtol=1e-5)
WIRE32 = dict(atol=1e-5, rtol=1e-4)       # served scores: tests/test_torch_serving.py
L, BATCH, STEPS, LR = 64, 32, 5, 5e-3
# (name, kind, interest overrides): the Table 2/3 settings of each kind
CASES = [("avg", "avg", {}), ("sim_hard", "sim_hard", {"top_k": 16}),
         ("eta", "eta", {"top_k": 16}), ("ubr4ctr", "ubr4ctr", {"top_k": 16}),
         ("din_mlp", "din_mlp", {}), ("sdim", "sdim", {"m": 48, "tau": 3}),
         ("sdim-srht", "sdim", {"m": 48, "tau": 3, "family": "srht"})]
HASHED = ("eta", "sdim")
# what the rows screened at MARGIN must keep after the steps moved them:
# still 50x the worst rounding of a 32-term fp32 dot product (~2e-6)
STEP_MARGIN = MARGIN / 10


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(kind, overrides):
    family = overrides.get("family", "dense")
    kw = {k: v for k, v in overrides.items() if k != "family"}
    cfg, jcfg = common.paper_model_config(kind, L, **kw), jcommon.paper_model_config(kind, L, **kw)
    return (dataclasses.replace(cfg, interest=dataclasses.replace(cfg.interest, family=family)),
            dataclasses.replace(jcfg, interest=dataclasses.replace(
                jcfg.interest, family=family, backend="xla")))


def test_auc_matches_benchmarks_common():
    rng = np.random.default_rng(0)
    labels = (rng.random(500) > 0.6).astype(np.float32)
    for scores in (rng.integers(0, 6, 500).astype(np.float32),      # heavy ties
                   rng.standard_normal(500).astype(np.float32),
                   np.zeros(500, np.float32)):
        assert common.auc(labels, scores) == jcommon.auc(labels, scores)
    assert common.auc(np.ones(4), np.arange(4.0)) == jcommon.auc(np.ones(4), np.arange(4.0)) == 0.5
    assert common.auc(np.array([0, 0, 1, 1.0]), np.array([0.1, 0.4, 0.35, 0.8])) == 0.75


def test_paper_configs_match_benchmarks_common():
    assert dataclasses.asdict(common.paper_data_config(128)) == dataclasses.asdict(
        jcommon.paper_data_config(128))
    for kind, kw in table23_auc.BASELINES:
        ours = dataclasses.asdict(common.paper_model_config(kind, 128, **kw))
        theirs = dataclasses.asdict(jcommon.paper_model_config(kind, 128, **kw))
        for field in ("arch", "n_items", "n_cats", "embed_dim", "short_len", "long_len",
                      "mlp_hidden", "ctx_dim", "emb_init"):
            assert ours[field] == theirs[field], field
        for field in ("kind", "m", "tau", "top_k", "hash_seed", "family"):
            assert ours["interest"][field] == theirs["interest"][field], field


def _behaviors(params, items, cats, cfg):
    return np.concatenate([np.asarray(params["item_emb"]["table"])[items % cfg.n_items],
                           np.asarray(params["cat_emb"]["table"])[cats % cfg.n_cats]], axis=-1)


def _assert_screened(kind, params, batch, cfg):
    """On ``params`` (the JAX tree): every row the step hashes clears the
    margin (sdim, eta); every example's top-k boundary is apart
    (ubr4ctr)."""
    valid = batch["hist_mask"] > 0
    if kind in HASHED:
        rows = np.concatenate([
            _behaviors(params, batch["hist_items"][valid], batch["hist_cats"][valid], cfg),
            _behaviors(params, batch["cand_item"], batch["cand_cat"], cfg)])
        assert clears_margin(rows, np.asarray(params["interest"]["buffers"]["R"]),
                             STEP_MARGIN).all()
    if kind == "ubr4ctr":
        seq = _behaviors(params, batch["hist_items"], batch["hist_cats"], cfg).astype(np.float64)
        q = _behaviors(params, batch["cand_item"], batch["cand_cat"], cfg).astype(np.float64)
        wq, wk = (np.asarray(params["interest"][w]["w"], np.float64) for w in ("wq", "wk"))
        scores = np.where(valid, np.einsum("bp,blp->bl", q @ wq, seq @ wk), -np.inf)
        assert topk_clear(scores, cfg.interest.top_k, STEP_MARGIN).all()


@pytest.mark.parametrize("name,kind,overrides", CASES, ids=[c[0] for c in CASES])
def test_train_loop_matches_jax(name, kind, overrides):
    cfg, jcfg = _cfgs(kind, overrides)
    dcfg, jdcfg = common.paper_data_config(L), jcommon.paper_data_config(L)
    jmodel = JCTRModel(jcfg)
    model = load_jax_params(CTRModel(cfg, device="cpu"),
                            _np_tree(jmodel.init(jax.random.PRNGKey(0))))
    stream = JDeterministicStream(lambda s: jgenerate_batch_graded(jdcfg, BATCH, s), base_seed=0)
    batches = [next(stream) for _ in range(STEPS)]
    tb = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    if kind in HASHED:
        screen_item_rows(model, tb, torch.Generator().manual_seed(0))
    if kind == "ubr4ctr":
        screen_topk_rows(model, tb, torch.Generator().manual_seed(0))
    params = jax.tree_util.tree_map(jnp.asarray, export_params(model))

    # the JAX package's loop, step by step
    init_state, step_fn = jmake_train_step(lambda p, b: jmodel.loss(p, b)[0],
                                           jopt.OptimizerConfig(kind="adamw", lr=LR),
                                           donate=False)
    state, jlosses = init_state(params), []
    for b in batches:
        _assert_screened(kind, _np_tree(state["params"]), b, cfg)
        state, metrics = step_fn(state, {k: jnp.asarray(v) for k, v in b.items()})
        jlosses.append(float(metrics["loss"]))

    run = common.train(model, dcfg, STEPS, BATCH, seed=0, lr=LR)
    assert run["first_nonfinite"] is None and len(run["losses"]) == STEPS
    np.testing.assert_allclose(run["losses"], np.array(jlosses, np.float32), **FP32)

    # one eval batch on the trained port model's weights, in both packages
    eb = generate_batch_graded(dcfg, common.EVAL_BATCH, common.EVAL_SEED0)
    teb = [{k: torch.from_numpy(v) for k, v in eb.items()}]
    if kind in HASHED:
        screen_item_rows(model, teb, torch.Generator().manual_seed(1))
    if kind == "ubr4ctr":
        screen_topk_rows(model, teb, torch.Generator().manual_seed(1))
    labels, scores = common.evaluate(model, dcfg, common.EVAL_BATCH)
    np.testing.assert_array_equal(labels, eb["label"])
    trained = jax.tree_util.tree_map(jnp.asarray, export_params(model))
    _assert_screened(kind, _np_tree(trained), eb, cfg)
    theirs = jmodel.apply(trained, {k: jnp.asarray(v) for k, v in eb.items()})
    np.testing.assert_allclose(scores, np.asarray(theirs), **FP32)


@pytest.mark.parametrize("kind", ["avg", "target"])
def test_train_and_eval_matches_benchmarks_common(kind):
    """The whole protocol, three steps at L = 64: the port's
    train_and_eval from the JAX package's initial parameters (what
    benchmarks.common.train_and_eval starts from at seed 0) reaches the
    same AUC, to the 1e-4 that one swapped pair of near-tied scores in
    1,024 could move it."""
    kw = dict(steps=3, batch=BATCH, eval_examples=1024, long_len=L, lr=LR)
    jcfg = jcommon.paper_model_config(kind, L)
    params = _np_tree(JCTRModel(jcfg).init(jax.random.PRNGKey(0)))
    ours = common.train_and_eval(kind, device="cpu", params=params, **kw)
    theirs = jcommon.train_and_eval(kind, **kw)
    assert ours["kind"] == theirs["kind"] == kind and ours["first_nonfinite"] is None
    assert abs(ours["auc"] - theirs["auc"]) <= 1e-4
    assert ours["us_per_step"] > 0


@pytest.mark.parametrize("kind", ["eta", "din_mlp", "ubr4ctr"])
def test_weights_and_masks_of_the_new_parameters(kind):
    """load_jax_params / export_params round-trip the kind's parameters
    exactly; the trainability and decay masks give them (and ETA's R, a
    buffer) what the JAX package's masks give them."""
    cfg, jcfg = _cfgs(kind, {"top_k": 16})
    params_np = _np_tree(JCTRModel(jcfg).init(jax.random.PRNGKey(3)))
    model = load_jax_params(CTRModel(cfg, device="cpu"), params_np)
    back = export_params(model)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params_np)
    names = {"eta": {"interest.R": ("buffers", "R")},
             "din_mlp": {"interest.din.mlp.fc0.weight": ("mlp", "fc0", "w"),
                         "interest.din.mlp.fc0.bias": ("mlp", "fc0", "b"),
                         "interest.din.mlp.fc1.weight": ("mlp", "fc1", "w"),
                         "interest.din.mlp.fc1.bias": ("mlp", "fc1", "b")},
             "ubr4ctr": {"interest.ubr.wq.weight": ("wq", "w"),
                         "interest.ubr.wk.weight": ("wk", "w")}}[kind]
    jt, jd = jopt.trainable_mask(params_np), jopt.decay_mask(params_np)
    tm, dm = trainable_mask(model), decay_mask(model)
    for name, path in names.items():
        t, d = jt["interest"], jd["interest"]
        for key in path:
            t, d = t[key], d[key]
        assert tm[name] == bool(t) and dm[name] == bool(d), name


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
N_USERS, C = 5, 6


def _smoke(kind, **kw):
    jcfg, cfg = jcfgs.SMOKE, sdim_paper.SMOKE
    jcfg = dataclasses.replace(jcfg, interest=dataclasses.replace(
        jcfg.interest, kind=kind, backend="xla", **kw))
    return dataclasses.replace(cfg, interest=dataclasses.replace(cfg.interest, kind=kind, **kw)), jcfg


def _requests(cfg, params_np, seed=0):
    """Requests whose hashed rows clear the margin where the kind hashes:
    ids are redrawn until they do."""
    rng = np.random.default_rng(seed)
    R = params_np["interest"].get("buffers", {}).get("R")

    def ids(shape):
        items = rng.integers(0, cfg.n_items, shape)
        cats = rng.integers(0, 4, shape)          # few categories: sim_hard finds matches
        while R is not None:
            bad = ~clears_margin(_behaviors(params_np, items, cats, cfg), R)
            if not bad.any():
                break
            items[bad] = rng.integers(0, cfg.n_items, int(bad.sum()))
        return items.astype(np.int32), cats.astype(np.int32)

    Lh = cfg.long_len
    hi, hc = ids((N_USERS, Lh))
    lengths = rng.integers(Lh // 4, Lh + 1, N_USERS)
    lengths[1] = 0                                 # a user with no history
    mask = (np.arange(Lh)[None] >= (Lh - lengths[:, None])).astype(np.float32)
    ci, cc = ids((N_USERS, C))
    ctx = rng.integers(0, 2, (N_USERS, C, cfg.ctx_dim)).astype(np.float32)
    return [(f"u{u}", {"hist_items": hi[u:u + 1], "hist_cats": hc[u:u + 1],
                       "hist_mask": mask[u:u + 1]}, ci[u], cc[u], ctx[u])
            for u in range(N_USERS)]


@pytest.mark.parametrize("kind", ["avg", "sim_hard", "eta", "ubr4ctr", "din_mlp",
                                  "sdim_expected"])
def test_inline_server_serves_every_kind(kind):
    """ubr4ctr: the item rows at each candidate's top-k boundary are
    redrawn until the k-th and (k+1)-th scores are apart, and the JAX
    server gets the redrawn weights."""
    cfg, jcfg = _smoke(kind, top_k=8)
    jmodel = JCTRModel(jcfg)
    params_np = _np_tree(jmodel.init(jax.random.PRNGKey(0)))
    requests = _requests(cfg, params_np)
    model = load_jax_params(CTRModel(cfg, device="cpu"), params_np)
    if kind == "ubr4ctr":
        burst = {k: torch.as_tensor(np.concatenate([r[1][k] for r in requests]))
                 for k in ("hist_items", "hist_cats", "hist_mask")}
        burst["cand_item"] = torch.as_tensor(np.stack([r[2] for r in requests]))
        burst["cand_cat"] = torch.as_tensor(np.stack([r[3] for r in requests]))
        screen_topk_rows(model, [burst], torch.Generator().manual_seed(0))
        assert topk_clear(ubr4ctr_scores(model, burst).numpy(), cfg.interest.top_k).all()
        params_np = export_params(model)
    jparams = jax.tree_util.tree_map(jnp.asarray, params_np)
    server = CTRServer.build(model, None, "inline", device="cpu")
    ours = server.handle_requests(requests)
    theirs = JCTRServer.build(jmodel, jparams, "inline").handle_requests(requests)
    assert len(ours) == N_USERS
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, np.asarray(b), **WIRE32)


def test_srht_sdim_serves_decoupled():
    """An sdim model of the SRHT family serves decoupled (its R is the
    family's dense matrix) as the JAX package's does, fp32 wire; inline
    gives the same scores."""
    cfg, jcfg = _smoke("sdim", family="srht")
    jmodel = JCTRModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params_np = _np_tree(jparams)
    R = params_np["interest"]["buffers"]["R"]
    assert np.array_equal(R, np.round(R)) and not np.array_equal(
        R, _np_tree(JCTRModel(_smoke("sdim")[1]).init(jax.random.PRNGKey(0)))
        ["interest"]["buffers"]["R"])
    requests = _requests(cfg, params_np)
    model = CTRModel(cfg, device="cpu")
    dec = CTRServer.build(model, params_np, "decoupled", wire_dtype=torch.float32, device="cpu")
    ours = dec.handle_requests(requests)
    theirs = JCTRServer.build(jmodel, jparams, "decoupled",
                              wire_dtype=jnp.float32).handle_requests(requests)
    inline = CTRServer.build(model, None, "inline", device="cpu").handle_requests(requests)
    for a, b, c in zip(ours, theirs, inline):
        np.testing.assert_allclose(a, np.asarray(b), **WIRE32)
        np.testing.assert_allclose(c, a, **WIRE32)


def test_table23_smoke_runs_on_the_cpu(capsys):
    """``python -m repro_torch.bench.table23_auc --smoke --device cpu``:
    one JSON row per kind and per claim; every kind trains with finite
    losses except sdim_expected, whose first step already has a non-finite
    gradient (ROADMAP.md §C, C2)."""
    rows = table23_auc.main(["--smoke", "--device", "cpu"])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed == rows
    names = [r["name"] for r in rows]
    assert names == [f"table23/{k}" for k, _ in table23_auc.BASELINES] + [
        "table23/claim_sdim_matches_din_long", "table23/claim_sdim_beats_retrieval"]
    for r in rows[:len(table23_auc.BASELINES)]:
        assert 0.0 <= r["auc"] <= 1.0 and r["us_per_call"] > 0
        assert r["first_nonfinite_step"] == (0 if r["name"] == "table23/sdim_expected" else None)
