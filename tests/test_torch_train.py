"""Port parity, the training slice: ``repro_torch``'s loss, gradients,
optimizers, loop, checkpoints, compression, data stream and launcher
against the JAX package on the CPU.

The model is the JAX tests' tiny din CTR model (tests/test_train.py
``_tiny_model``: 500 items, 20 categories, L = 32, MLP 16-8, m = 8,
tau = 2) for interest kinds ``sdim``, ``target`` and ``none``; the JAX side
runs the XLA backend, the weights cross by ``load_jax_params`` and the
gradients come back by ``export_params``. For kind ``sdim`` the item rows
of every behavior and candidate a step hashes are redrawn until each clears
1e-3·‖r‖‖x‖ (``kernels.screen.screen_item_rows``; the tests assert it), so
both frameworks agree on every signature bit; since an optimizer step moves
the embeddings, sdim is held one step at a time and the multi-step parity
is for ``target`` and ``none``. Optimizer updates are held one at a time
from identical numpy gradients (Adam and Adagrad divide by sqrt(v) + eps,
which would turn tiny gradient differences into full-size ones).

Tolerances: loss and gradients fp32 atol 1e-5 / rtol 1e-5; one optimizer
update atol 1e-6 / rtol 1e-6; five SGD steps atol 1e-5 / rtol 1e-5 (the
same arithmetic in another order); gradient accumulation against the full
batch rtol 2e-4 / atol 2e-5, the reference's own (tests/test_train.py).
"""
import dataclasses
import os
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.interest import InterestConfig as JInterestConfig
from repro.data import synthetic as jsynthetic
from repro.data.pipeline import DeterministicStream as JDeterministicStream
from repro.models.ctr import CTRConfig as JCTRConfig
from repro.models.ctr import CTRModel as JCTRModel
from repro.train import compression as jcompression
from repro.train import optimizer as jopt
from repro.train.loop import make_train_step as jmake_train_step
from repro_torch.core.interest import InterestConfig
from repro_torch.data import synthetic
from repro_torch.data.pipeline import DeterministicStream, Prefetcher, shard_batch
from repro_torch.kernels.screen import hashed_behaviors, item_rows_clear, screen_item_rows
from repro_torch.launch import train as launch_train
from repro_torch.models.ctr import CTRConfig, CTRModel
from repro_torch.train import checkpoint as ck
from repro_torch.train.compression import (dequantize_int8, ef_compress, init_error_feedback,
                                           quantize_int8)
from repro_torch.train.loop import LoopConfig, Watchdog, make_train_step, run
from repro_torch.train.optimizer import (OptimizerConfig, apply_updates, clip_by_global_norm,
                                         decay_mask, global_norm, init_opt_state, schedule_fn,
                                         trainable_mask)
from repro_torch.weights import export_params, load_jax_params

KINDS = ["sdim", "target", "none"]
FP32 = dict(atol=1e-5, rtol=1e-5)
UPDATE = dict(atol=1e-6, rtol=1e-6)
DCFG = synthetic.SyntheticCTRConfig(hist_len=32, n_items=500, n_cats=20)
JDCFG = jsynthetic.SyntheticCTRConfig(hist_len=32, n_items=500, n_cats=20)


def _cfgs(kind):
    small = dict(arch="din", n_items=500, n_cats=20, long_len=32, short_len=8,
                 mlp_hidden=(16, 8))
    return (CTRConfig(**small, interest=InterestConfig(kind=kind, m=8, tau=2)),
            JCTRConfig(**small, interest=JInterestConfig(kind=kind, m=8, tau=2,
                                                         backend="xla")))


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _pair(kind, batches=(), seed=0):
    """(port model, JAX model, JAX params) on the same weights: the JAX
    init, with (sdim) the item rows that ``batches`` hash screened."""
    cfg, jcfg = _cfgs(kind)
    jmodel = JCTRModel(jcfg)
    params_np = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    model = load_jax_params(CTRModel(cfg, device="cpu"), params_np)
    if kind == "sdim" and batches:
        tb = [_torch_batch(b) for b in batches]
        screen_item_rows(model, tb, torch.Generator().manual_seed(seed))
        for b in tb:
            assert bool(item_rows_clear(model, *hashed_behaviors(model, b)).all())
    jparams = jax.tree_util.tree_map(jnp.asarray, export_params(model))
    return model, jmodel, jparams


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _assert_trees_close(ours, theirs, **tol):
    ours, theirs = _flat(ours), _flat(theirs)
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        np.testing.assert_allclose(ours[k], theirs[k], err_msg=k, **tol)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", KINDS)
def test_loss_and_gradient_tree_match_jax(kind):
    """One step's loss, logits and every parameter's gradient (R's is zero
    on both sides) against jax.grad of the JAX model.loss."""
    batch = synthetic.generate_batch(DCFG, 16, 3)
    model, jmodel, jparams = _pair(kind, [batch])
    (jloss, jlogits), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jparams)
    loss, logits = model.loss(_torch_batch(batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **FP32)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), **FP32)
    grads = export_params(model, grad=True)
    _assert_trees_close(grads, jax.tree_util.tree_map(np.asarray, jgrads), **FP32)
    if kind != "none":      # the long branch reaches rows that only the long history holds
        short = set(batch["hist_items"][:, -8:].ravel()) | set(batch["cand_item"].ravel())
        long_only = sorted(set(batch["hist_items"][batch["hist_mask"] > 0].ravel()) - short)
        assert long_only and np.abs(grads["item_emb"]["table"][long_only]).max() > 0


@pytest.mark.parametrize("kind", ["sdim", "target"])
def test_score_candidates_matches_jax(kind):
    """score_candidates (the B = 1 case of score_candidates_many) on one
    user's request, inline, against the JAX model's."""
    req = synthetic.serving_request(DCFG, 6, 4)
    user = {k: req[k][None] for k in ("hist_items", "hist_cats", "hist_mask")}
    batch = {**user, "cand_item": req["cand_item"][None], "cand_cat": req["cand_cat"][None]}
    model, jmodel, jparams = _pair(kind, [batch])
    with torch.no_grad():
        ours = model.score_candidates(_torch_batch(user), torch.from_numpy(req["cand_item"]),
                                      torch.from_numpy(req["cand_cat"]),
                                      torch.from_numpy(req["ctx"]))
    theirs = jmodel.score_candidates(jparams, {k: jnp.asarray(v) for k, v in user.items()},
                                     jnp.asarray(req["cand_item"]), jnp.asarray(req["cand_cat"]),
                                     jnp.asarray(req["ctx"]))
    assert ours.shape == (6,)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **FP32)


def test_export_params_inverts_load_jax_params():
    cfg, jcfg = _cfgs("sdim")
    params_np = jax.tree_util.tree_map(np.asarray, JCTRModel(jcfg).init(jax.random.PRNGKey(1)))
    back = export_params(load_jax_params(CTRModel(cfg, device="cpu"), params_np))
    _assert_trees_close(back, params_np, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# optimizer: one update from identical gradients
# ---------------------------------------------------------------------------
def _numpy_grads(params_np, seed):
    """Random gradients of every parameter; R's is zero, as jax.grad gives
    it (a buffer behind comparisons)."""
    rng = np.random.default_rng(seed)
    grads = jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape) * 0.3).astype(np.float32), params_np)
    grads["interest"]["buffers"]["R"] = np.zeros_like(grads["interest"]["buffers"]["R"])
    return grads


def _port_grads(grads_np, model):
    """The JAX tree's gradients under the port's parameter names."""
    out = {"item_emb.weight": grads_np["item_emb"]["table"],
           "cat_emb.weight": grads_np["cat_emb"]["table"]}
    for i in range(model.head.n_layers):
        out[f"head.fc{i}.weight"] = grads_np["head"][f"fc{i}"]["w"].T
        out[f"head.fc{i}.bias"] = grads_np["head"][f"fc{i}"]["b"]
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in out.items()}


OPT_CASES = {
    "adamw": OptimizerConfig(kind="adamw", lr=1e-2, weight_decay=0.1),
    "adamw-master": OptimizerConfig(kind="adamw", lr=1e-2, master_weights=True),
    "adagrad": OptimizerConfig(kind="adagrad", lr=0.05, clip_norm=10.0),
    "sgd": OptimizerConfig(kind="sgd", lr=5e-2, momentum=0.9),
    "sgd-cosine": OptimizerConfig(kind="sgd", lr=0.1, schedule="warmup_cosine",
                                  warmup_steps=1, total_steps=10, clip_norm=None),
    "adamw-rsqrt": OptimizerConfig(kind="adamw", lr=1e-2, schedule="warmup_rsqrt",
                                   warmup_steps=1),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_updates_match_jax(case):
    """Two updates (count 0 and 1) from the same numpy gradients: the
    parameters and every moment within 1e-6; R untouched."""
    cfg = OPT_CASES[case]
    jcfg = jopt.OptimizerConfig(**dataclasses.asdict(cfg))
    model, _, jparams = _pair("sdim")
    R0 = model.interest.R.clone()
    state, jstate = init_opt_state(model, cfg), jopt.init_opt_state(jparams, jcfg)
    for seed in (1, 2):
        grads_np = _numpy_grads(jax.tree_util.tree_map(np.asarray, jparams), seed)
        jparams, jstate, jm = jopt.apply_updates(
            jparams, jax.tree_util.tree_map(jnp.asarray, grads_np), jstate, jcfg)
        state, m = apply_updates(model, _port_grads(grads_np, model), state, cfg)
        _assert_trees_close(export_params(model), jax.tree_util.tree_map(np.asarray, jparams),
                            **UPDATE)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
        if cfg.clip_norm is not None:
            np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    assert int(state["count"]) == int(jstate["count"]) == 2
    assert torch.equal(model.interest.R, R0)
    for moment in ("m", "v"):
        if moment in jstate:
            ours = state[moment]
            theirs = _port_grads(jax.tree_util.tree_map(np.asarray, jstate[moment]), model)
            for k, v in theirs.items():
                np.testing.assert_allclose(ours[k].numpy(), v.numpy(), err_msg=k, **UPDATE)


@pytest.mark.parametrize("schedule", ["constant", "warmup_cosine", "warmup_rsqrt"])
def test_schedules_match_jax(schedule):
    cfg = OptimizerConfig(lr=0.3, schedule=schedule, warmup_steps=10, total_steps=100,
                          min_lr_frac=0.1)
    ours, theirs = schedule_fn(cfg), jopt.schedule_fn(jopt.OptimizerConfig(
        **dataclasses.asdict(cfg)))
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 250):
        np.testing.assert_allclose(float(ours(step)), float(theirs(jnp.int32(step))),
                                   rtol=1e-6, err_msg=str(step))


def test_clip_by_global_norm_matches_jax():
    rng = np.random.default_rng(0)
    g = {"a": rng.standard_normal(7).astype(np.float32) * 10,
         "b": rng.standard_normal((3, 4)).astype(np.float32) * 10}
    for max_norm in (1.0, 1e3):
        ours, norm = clip_by_global_norm({k: torch.from_numpy(v) for k, v in g.items()},
                                         max_norm)
        theirs, jnorm = jopt.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()},
                                                 max_norm)
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
        for k in g:
            np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]), **UPDATE)
    assert abs(float(global_norm(clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in g.items()}, 1.0)[0].values())) - 1.0) < 1e-5


def test_masks_match_jax():
    """The trainability and decay masks by name, against the JAX masks of
    the same tree: R (a buffer) is neither trained nor decayed; biases are
    not decayed."""
    model, _, jparams = _pair("sdim")
    jt, jd = jopt.trainable_mask(jparams), jopt.decay_mask(jparams)
    names = {"item_emb.weight": ("item_emb", "table"), "cat_emb.weight": ("cat_emb", "table"),
             "interest.R": ("interest", "buffers", "R"),
             "head.fc0.weight": ("head", "fc0", "w"), "head.fc0.bias": ("head", "fc0", "b")}
    tm, dm = trainable_mask(model), decay_mask(model)
    for name, path in names.items():
        jt_leaf, jd_leaf = jt, jd
        for p in path:
            jt_leaf, jd_leaf = jt_leaf[p], jd_leaf[p]
        assert tm[name] is jt_leaf and dm[name] is jd_leaf, name
    assert sorted(tm) == sorted(dm) and "interest.R" in tm


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------
def _stream(seed=3, batch=8):
    return DeterministicStream(lambda s: synthetic.generate_batch(DCFG, batch, s), seed)


@pytest.mark.parametrize("kind", ["target", "none"])
def test_five_sgd_steps_match_jax(kind):
    """make_train_step on both sides, five SGD steps (momentum 0.9, clip 1)
    on the same stream."""
    model, jmodel, jparams = _pair(kind)
    cfg = OptimizerConfig(kind="sgd", lr=0.05)
    init, step = make_train_step(lambda m, b: m.loss(b)[0], cfg)
    jinit, jstep = jmake_train_step(lambda p, b: jmodel.loss(p, b)[0],
                                    jopt.OptimizerConfig(**dataclasses.asdict(cfg)),
                                    donate=False)
    state, jstate = init(model), jinit(jparams)
    stream = _stream()
    for _ in range(5):
        batch = next(stream)
        state, m = step(state, _torch_batch(batch))
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **FP32)
    _assert_trees_close(export_params(model),
                        jax.tree_util.tree_map(np.asarray, jstate["params"]), **FP32)


def test_grad_accum_matches_full_batch():
    """Four microbatches against the whole batch (the reference's own
    tolerance), and against the JAX loop's four microbatches."""
    batch = synthetic.generate_batch(DCFG, 32, 0)
    cfg = OptimizerConfig(kind="sgd", lr=1e-2, momentum=0.0, clip_norm=None)
    results = {}
    for accum in (1, 4):
        model, jmodel, jparams = _pair("sdim", [batch])
        init, step = make_train_step(lambda m, b: m.loss(b)[0], cfg, grad_accum=accum)
        state, metrics = step(init(model), _torch_batch(batch))
        results[accum] = export_params(model), float(metrics["loss"])
    _assert_trees_close(results[4][0], results[1][0], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(results[4][1], results[1][1], rtol=1e-6)
    jinit, jstep = jmake_train_step(lambda p, b: jmodel.loss(p, b)[0],
                                    jopt.OptimizerConfig(**dataclasses.asdict(cfg)),
                                    grad_accum=4, donate=False)
    jstate, _ = jstep(jinit(jparams), {k: jnp.asarray(v) for k, v in batch.items()})
    _assert_trees_close(results[4][0], jax.tree_util.tree_map(np.asarray, jstate["params"]),
                        **FP32)


def test_resume_after_preempt_is_bit_identical():
    """A run preempted after step 3 and restarted from its checkpoint ends
    with the same bits as an uninterrupted 8-step run (AdamW, sdim)."""
    cfg = OptimizerConfig(kind="adamw", lr=1e-3)
    loss_fn = lambda m, b: m.loss(b)[0]
    loop = lambda d: LoopConfig(n_steps=8, log_every=1, ckpt_every=4, ckpt_dir=d)
    with tempfile.TemporaryDirectory() as d1, tempfile.TemporaryDirectory() as d2:
        whole = run(loss_fn, _pair("sdim")[0], _stream(), cfg, loop(d1))
        ev = threading.Event()
        first = run(loss_fn, _pair("sdim")[0], _stream(), cfg, loop(d2), preempt_event=ev,
                    log_fn=lambda s, m: ev.set() if s == 2 else None)
        assert first["stopped_at"] == 3 and ck.latest_step(d2) == 3
        second = run(loss_fn, _pair("sdim")[0], _stream(), cfg, loop(d2))
        assert second["stopped_at"] == 8 and [s for s, _ in second["history"]] == list(range(3, 8))
        a, b = whole["state"]["model"], second["state"]["model"]
        for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
            assert torch.equal(x, y), k
        for k, v in whole["state"]["opt"]["v"].items():
            assert torch.equal(v, second["state"]["opt"]["v"][k]), k
        assert whole["history"][-1][1]["loss"] == second["history"][-1][1]["loss"]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip_atomicity_and_latest_step():
    model = _pair("sdim")[0]
    state = {"model": model, "opt": init_opt_state(model, OptimizerConfig(kind="adagrad")),
             "step": 7}
    state["opt"]["v"]["head.fc0.bias"].fill_(0.25)
    with tempfile.TemporaryDirectory() as d:
        assert ck.latest_step(d) is None
        ck.save(d, 7, state)
        open(os.path.join(d, ".tmp-9-1"), "wb").close()          # a save cut off mid-write
        assert ck.latest_step(d) == 7
        fresh = _pair("sdim", seed=5)[0]
        template = {"model": fresh, "opt": init_opt_state(fresh, OptimizerConfig(kind="adagrad")),
                    "step": 0}
        restored, step = ck.restore(d, template)
        assert step == 7 and restored["step"] == 7 and restored["model"] is fresh
        for (k, x), (_, y) in zip(model.state_dict().items(), fresh.state_dict().items()):
            assert torch.equal(x, y), k
        assert torch.equal(restored["opt"]["v"]["head.fc0.bias"],
                           torch.full_like(restored["opt"]["v"]["head.fc0.bias"], 0.25))
        assert int(restored["opt"]["count"]) == 0
        meta = __import__("json").load(open(os.path.join(d, "step_0000000007.json")))
        assert meta["step"] == 7 and meta["manifest"]["model/interest.R"] == [8, 64]
        assert not [f for f in os.listdir(d) if f.startswith(".tmp") and f != ".tmp-9-1"]
        bad = {"model": CTRModel(dataclasses.replace(_cfgs("sdim")[0], n_items=7), device="cpu")}
        with pytest.raises(ValueError, match="shape mismatch"):
            ck.restore(d, bad)
        with pytest.raises(KeyError):
            ck.restore(d, {"missing": torch.zeros(2)})


def test_async_checkpointer_keeps_the_last_three():
    model = _pair("none")[0]
    with tempfile.TemporaryDirectory() as d:
        saver = ck.AsyncCheckpointer(d)
        for s in (1, 2, 3, 4, 5):
            saver.save(s, {"model": model})
            with torch.no_grad():
                model.head.fc0.bias.add_(1.0)        # after save: the snapshot is taken
        saver.wait()
        assert sorted(int(f[5:-4]) for f in os.listdir(d) if f.endswith(".npz")) == [3, 4, 5]
        restored, _ = ck.restore(d, {"model": model}, step=3)
        assert float(restored["model"].head.fc0.bias.detach()[0]) == pytest.approx(
            float(_pair("none")[0].head.fc0.bias.detach()[0]) + 2.0)


# ---------------------------------------------------------------------------
# compression and the watchdog
# ---------------------------------------------------------------------------
def test_int8_quantization_matches_jax():
    x = np.random.default_rng(0).standard_normal(300).astype(np.float32)
    q, s = quantize_int8(torch.from_numpy(x))
    jq, js = jcompression.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_allclose(float(s), float(js), rtol=1e-7)
    assert np.abs(q.numpy().astype(int) - np.asarray(jq).astype(int)).max() <= 1
    assert float((dequantize_int8(q, s) - torch.from_numpy(x)).abs().max()) <= float(s) + 1e-6


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_error_feedback_preserves_the_sum(mode):
    """The compressed gradients of ten steps plus the final residual add up
    to the ten raw gradients."""
    g = {"w": torch.from_numpy(np.random.default_rng(1).standard_normal(64).astype(np.float32))}
    ef = init_error_feedback(g)
    total = torch.zeros(64)
    for _ in range(10):
        comp, ef = ef_compress(g, ef, mode)
        total = total + comp["w"]
    torch.testing.assert_close(total + ef["w"], 10 * g["w"], rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        ef_compress(g, ef, "fp4")


def test_compressed_training_step_runs():
    model = _pair("target")[0]
    init, step = make_train_step(lambda m, b: m.loss(b)[0], OptimizerConfig(kind="sgd"),
                                 compress="int8")
    state = init(model)
    state, m = step(state, _torch_batch(next(_stream())))
    assert np.isfinite(float(m["loss"])) and float(state["ef"]["head.fc0.weight"].abs().max()) > 0


def test_watchdog_flags_stragglers():
    w = Watchdog(factor=3.0)
    for i in range(10):
        assert w.observe(i, 0.1) is False
    assert w.observe(10, 1.0) is True and w.flags == [10]
    assert w.observe(11, 0.11) is False


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
def test_stream_seeds_match_jax():
    for base, host, n_hosts in ((0, 0, 1), (3, 1, 4), (12345, 3, 4)):
        ours = DeterministicStream(lambda s: s, base, host_id=host, n_hosts=n_hosts)
        theirs = JDeterministicStream(lambda s: s, base, host_id=host, n_hosts=n_hosts)
        assert [ours.seed_for(s) for s in range(50)] == [theirs.seed_for(s) for s in range(50)]
    stream = DeterministicStream(lambda s: s, 7)
    first = [next(stream) for _ in range(5)]
    stream.skip_to(2)
    assert next(stream) == first[2]


@pytest.mark.parametrize("seed", [0, 11])
def test_graded_batches_and_requests_match_jax(seed):
    ours, theirs = (synthetic.generate_batch_graded(DCFG, 16, seed),
                    jsynthetic.generate_batch_graded(JDCFG, 16, seed))
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
        assert ours[k].dtype == theirs[k].dtype
    ours, theirs = (synthetic.serving_request(DCFG, 9, seed),
                    jsynthetic.serving_request(JDCFG, 9, seed))
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    assert not synthetic._latents(DCFG, 8).flags.writeable


def test_prefetcher_and_shard_batch():
    batches = list(Prefetcher(iter([{"x": np.arange(8) + i} for i in range(5)]), depth=2))
    assert [int(b["x"][0]) for b in batches] == [0, 1, 2, 3, 4]
    part = shard_batch({"x": np.arange(8), "n": 3}, 1, 4)
    assert part["x"].tolist() == [2, 3] and part["n"] == 3

    def broken():
        yield {"x": 1}
        raise RuntimeError("source failed")

    it = Prefetcher(broken())
    assert next(it) == {"x": 1}
    with pytest.raises(RuntimeError, match="source failed"):
        next(it)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def test_launcher_trains_smoke_on_cpu(capsys):
    with tempfile.TemporaryDirectory() as d:
        out = launch_train.main(["--arch", "sdim-paper", "--device", "cpu", "--steps", "3",
                                 "--batch", "8", "--ckpt", d])
        assert out["stopped_at"] == 3 and ck.latest_step(d) == 3
        assert np.isfinite(out["history"][-1][1]["loss"])
    assert "finished at step 3" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "no-such-arch", "--device", "cpu"])
