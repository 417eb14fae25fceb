"""Port parity, LM training: the five LM archs' loss and its gradient,
remat, the chunked attention's gradient, the train loop and launcher, the
model-flops yardstick and ``PReLU``, against the JAX package on the CPU.

* The loss and the whole gradient tree (``weights.export_lm_params(model,
  grad=True)``) against ``jax.value_and_grad(LMModel.loss)`` for each arch
  at SMOKE, on the port's init carried to the reference, in fp32 and with
  ``compute_dtype="bfloat16"`` (the loss off a bf16 cast of the fp32
  parameters; the two MoE archs' bf16 case is fault C7: the router's
  product of fp32 activations with a bf16 weight raised).
* ``remat``: each of the four policies gives the loss and gradients of
  ``"none"`` bit for bit, and the backward pass recomputes the products a
  policy does not keep (counted at dispatch: ``"full"`` every product,
  ``"dots"`` none, ``"dots_no_batch"`` the batched ones); with the same
  ``remat`` set on the reference (``dataclasses.replace``) the gradients
  agree with its ``jax.checkpoint``-ed stack.
* The query-chunked causal attention's gradient (GQA and MLA, a small
  ``q_chunk``) against the masked path and the reference's chunked path.
* Five AdamW steps of ``launch.train.lm_setup`` through ``train.loop.run``
  against the reference's ``train.loop.run`` with its launcher's settings,
  from the reference's parameters: the loss at every step and the final
  parameters (granite-3-2b: tied embeddings, GQA; deepseek-v2-236b: MLA,
  MoE and a dense first block).
* The launcher for each LM arch on the CPU; a run preempted and resumed
  from its checkpoint ends with the bits of an uninterrupted one;
  ``lm_stream`` against the reference's ``_lm_stream``.
* ``launch.flops.model_flops`` equal to the reference's for every LM and
  recsys arch, shape and variant; ``PReLU`` against the reference's.

Tolerances: fp32 atol 1e-5 of the largest gradient (or parameter) and rtol
1e-5; bf16 compute atol 2e-2 of the largest gradient and rtol 2e-2 (the
reference's bf16 rtol, ``tests/test_kernels.py:46-58``); losses fp32 atol /
rtol 1e-5, bf16 rtol 2e-2.
"""
import dataclasses
import functools
import importlib.util
import os
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import registry as jregistry
from repro.data.pipeline import DeterministicStream as JDeterministicStream
from repro.launch import flops as jflops
from repro.launch.train import _lm_stream as jlm_stream
from repro.models.lm import LMModel as JLMModel
from repro.nn import attention as jattention
from repro.nn import layers as jlayers
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch.configs import registry
from repro_torch.launch import flops
from repro_torch.launch import train as launch_train
from repro_torch.models.lm import LMModel
from repro_torch.nn import attention
from repro_torch.nn.layers import PReLU
from repro_torch.nn.transformer import REMAT_POLICIES
from repro_torch.train import checkpoint as ck
from repro_torch.train.loop import LoopConfig, run
from repro_torch.weights import export_lm_params, load_jax_lm_params

LM_IDS = ("granite-3-2b", "qwen3-8b", "command-r-plus-104b", "deepseek-moe-16b",
          "deepseek-v2-236b")
RECSYS_IDS = ("wide-deep", "bst", "dien", "bert4rec", "sdim-paper")
FP32_REL, BF16_REL = 1e-5, 2e-2
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
LOSS = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=0.0, rtol=2e-2)}


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _init(arch_id, reference):
    """SMOKE parameters as numpy: the reference's init (PRNGKey(0)) with
    its R, or the port's (generator seed 0; cheaper to draw)."""
    if reference:
        jm = JLMModel(jregistry.get(arch_id).SMOKE)
        params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
        return params, np.asarray(jm._sdim_R())
    model = LMModel(registry.get(arch_id).SMOKE, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    return export_lm_params(model), model.R.numpy()


def _pair(arch_id, reference=False, **over):
    """(the reference's model, its params, the port's model on them) at
    SMOKE with the config fields ``over`` replaced on both sides; the
    parameters drawn by the reference (``reference``) or the port."""
    params, R = _init(arch_id, reference)
    jm = JLMModel(dataclasses.replace(jregistry.get(arch_id).SMOKE, **over))
    model = LMModel(dataclasses.replace(registry.get(arch_id).SMOKE, **over), device="cpu")
    load_jax_lm_params(model, params, R)
    return jm, jax.tree_util.tree_map(jnp.asarray, params), model


def _tokens(vocab, seed=0, shape=(2, 13)):
    toks = np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _flat(tree, prefix=""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _assert_trees_close(ours, theirs, rel):
    """Every leaf within atol ``rel`` · the tree's largest |value| and rtol
    ``rel``."""
    ours, theirs = _flat(ours), _flat(theirs)
    assert sorted(ours) == sorted(theirs)
    atol = rel * max(float(np.abs(v).max()) for v in theirs.values())
    for k in theirs:
        assert np.isfinite(ours[k]).all(), k
        np.testing.assert_allclose(ours[k], theirs[k], atol=atol, rtol=rel, err_msg=k)


def _loss_and_grads(model, tokens, targets):
    for p in model.parameters():
        p.grad = None
    loss = model.loss(_t(tokens), _t(targets))
    loss.backward()
    return loss.detach(), export_lm_params(model, grad=True)


def _jax_loss_and_grads(jm, params, tokens, targets):
    loss, grads = jax.jit(jax.value_and_grad(jm.loss))(params, jnp.asarray(tokens),
                                                        jnp.asarray(targets))
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


# ---------------------------------------------------------------------------
# the loss and its gradient
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch_id", LM_IDS)
def test_loss_and_gradient_tree_match_jax(arch_id, compute_dtype):
    """bf16 compute of deepseek-moe-16b and deepseek-v2-236b is fault C7
    (the router's fp32 x bf16 product raised before it was repaired)."""
    jm, params, model = _pair(arch_id, compute_dtype=compute_dtype)
    tokens, targets = _tokens(jm.cfg.vocab)
    loss, grads = _loss_and_grads(model, tokens, targets)
    jloss, jgrads = _jax_loss_and_grads(jm, params, tokens, targets)
    np.testing.assert_allclose(float(loss), jloss, **LOSS[compute_dtype])
    _assert_trees_close(grads, jgrads, FP32_REL if compute_dtype == "float32" else BF16_REL)
    # the master parameters stay fp32, and every one of them has a gradient
    assert all(p.dtype == torch.float32 and p.grad is not None and p.grad.dtype == torch.float32
               for p in model.parameters())


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------
class _CountProducts(TorchDispatchMode):
    """Counts the matrix products dispatched while it is on: two
    dimensions (mm, addmm) and batched (bmm, baddbmm)."""

    def __init__(self):
        super().__init__()
        self.mm = self.bmm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in REMAT_POLICIES["dots_no_batch"]:
            self.mm += 1
        elif func in REMAT_POLICIES["dots"]:
            self.bmm += 1
        return func(*args, **(kwargs or {}))


def _remat_run(arch_id, remat, compute_dtype):
    """(loss, gradient tree, products dispatched in the backward pass)."""
    model = _pair(arch_id, remat=remat, compute_dtype=compute_dtype)[2]
    tokens, targets = _tokens(model.cfg.vocab, seed=4)
    loss = model.loss(_t(tokens), _t(targets))
    with _CountProducts() as count:
        loss.backward()
    return loss.detach(), _flat(export_lm_params(model, grad=True)), (count.mm, count.bmm)


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_remat_policies_give_the_bits_of_none(arch_id):
    """Each policy's loss and gradients equal ``"none"``'s bit for bit, in
    fp32 and bf16 compute; the backward pass runs again the products the
    policy does not keep: all (full), none (dots), the batched ones
    (dots_no_batch)."""
    for compute_dtype in ("float32", "bfloat16"):
        loss, grads, (mm, bmm) = _remat_run(arch_id, "none", compute_dtype)
        again = {}
        for remat in ("full", "dots", "dots_no_batch"):
            r_loss, r_grads, (r_mm, r_bmm) = _remat_run(arch_id, remat, compute_dtype)
            assert torch.equal(r_loss, loss), (remat, compute_dtype)
            for k in grads:
                assert np.array_equal(r_grads[k], grads[k]), (remat, compute_dtype, k)
            again[remat] = (r_mm - mm, r_bmm - bmm)
        assert again["full"][0] > 0 and again["full"][1] > 0, again
        assert again["dots"] == (0, 0), again
        assert again["dots_no_batch"] == (0, again["full"][1]), again


@pytest.mark.parametrize("remat", list(REMAT_POLICIES))
def test_remat_gradients_match_jax_under_the_same_policy(remat):
    """granite-3-2b (tied embeddings): the reference's stack under
    ``jax.checkpoint`` with the same policy (the MoE and MLA archs reach the
    reference through "none": their policies give its bits)."""
    jm, params, model = _pair("granite-3-2b", remat=remat)
    tokens, targets = _tokens(jm.cfg.vocab, seed=4)
    loss, grads = _loss_and_grads(model, tokens, targets)
    jloss, jgrads = _jax_loss_and_grads(jm, params, tokens, targets)
    np.testing.assert_allclose(float(loss), jloss, **LOSS["float32"])
    _assert_trees_close(grads, jgrads, FP32_REL)


def test_remat_is_off_outside_autograd_and_checked():
    """Serving paths run blocks plainly (no checkpoint under no_grad: the
    same outputs, nothing kept); an unknown policy is refused."""
    model = _pair("granite-3-2b", remat="full")[2]
    tokens, _ = _tokens(model.cfg.vocab)
    with torch.no_grad(), _CountProducts() as count:
        h, _ = model(_t(tokens))
    plain = _pair("granite-3-2b", remat="none")[2]
    with torch.no_grad(), _CountProducts() as plain_count:
        hp, _ = plain(_t(tokens))
    assert torch.equal(h, hp) and (count.mm, count.bmm) == (plain_count.mm, plain_count.bmm)
    with pytest.raises(ValueError, match="remat"):
        LMModel(dataclasses.replace(registry.get("granite-3-2b").SMOKE, remat="some"),
                device="cpu")


# ---------------------------------------------------------------------------
# the chunked attention's gradient
# ---------------------------------------------------------------------------
def _gqa(q_chunk):
    d, H, Hkv, D = 16, 4, 2, 8
    jattn = jattention.GQAttention(d, H, Hkv, D, qk_norm=True, rope_theta=1e6, q_chunk=q_chunk)
    p = jattn.init(jax.random.PRNGKey(5))
    attn = attention.GQAttention(d, H, D, n_kv_heads=Hkv, qk_norm=True, use_bias=False,
                                 rope_theta=1e6, causal=True, q_chunk=q_chunk, device="cpu")
    with torch.no_grad():
        for name in ("wq", "wk", "wv", "wo"):
            getattr(attn, name).weight.copy_(_t(np.asarray(p[name]["w"]).T))
        attn.q_norm.scale.copy_(_t(p["q_norm"]["scale"]))
        attn.k_norm.scale.copy_(_t(p["k_norm"]["scale"]))
    return jattn, p, attn, d


def _mla(q_chunk):
    d, H = 64, 4
    widths = dict(kv_lora_rank=32, q_lora_rank=48, nope_head_dim=16, rope_head_dim=8,
                  v_head_dim=16)
    jattn = jattention.MLAttention(d_model=d, n_heads=H, q_chunk=q_chunk, **widths)
    p = jattn.init(jax.random.PRNGKey(6))
    attn = attention.MLAttention(d, H, q_chunk=q_chunk, device="cpu", **widths)
    with torch.no_grad():
        for name in ("wq_a", "wq_b", "wkv_a", "wk_b", "wv_b", "wo"):
            getattr(attn, name).weight.copy_(_t(np.asarray(p[name]["w"]).T))
        attn.q_a_norm.scale.copy_(_t(p["q_a_norm"]["scale"]))
        attn.kv_a_norm.scale.copy_(_t(p["kv_a_norm"]["scale"]))
    return jattn, p, attn, d


@pytest.mark.parametrize("kind", ["gqa", "mla"])
def test_chunked_attention_gradient_matches_masked_and_jax(kind):
    """T = 16 in chunks of 4 (both packages' chunked path) against the
    masked path (q_chunk above T) and the reference: the gradient of
    sum(out · w) in x and in every weight."""
    jattn, p, attn, d = (_gqa if kind == "gqa" else _mla)(4)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 16, d)).astype(np.float32)
    w = rng.standard_normal((2, 16, d)).astype(np.float32)

    def port(q_chunk):
        attn.q_chunk = q_chunk
        attn.zero_grad(set_to_none=True)
        xt = _t(x).requires_grad_()
        (attn(xt) * _t(w)).sum().backward()
        return {"x": xt.grad.numpy(), **{n: t.grad.numpy().copy()
                                         for n, t in attn.named_parameters()}}

    chunked, masked = port(4), port(64)
    jgx, jgp = jax.jit(jax.grad(lambda xx, pp: jnp.sum(jattn.apply(pp, xx) * w),
                                argnums=(0, 1)))(jnp.asarray(x), p)
    want = {"x": np.asarray(jgx)}
    for name, t in attn.named_parameters():
        mod, leaf = name.split(".")
        g = np.asarray(jgp[mod]["w" if leaf == "weight" else leaf])
        want[name] = g.T if leaf == "weight" else g
    _assert_trees_close(chunked, masked, FP32_REL)
    _assert_trees_close(chunked, want, FP32_REL)


# ---------------------------------------------------------------------------
# the train loop and the launcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch_id", ["granite-3-2b", "deepseek-v2-236b"])
def test_five_adamw_steps_match_the_reference_run(arch_id):
    """``lm_setup`` + ``train.loop.run`` against the reference's ``run``
    with its launcher's LM settings (AdamW 3e-4, warmup-cosine, clip 1), 5
    steps of batch 2 x 16 tokens from the reference's parameters: the loss
    of every step and the final parameters."""
    batch, seq, steps = 2, 16, 5
    jm, params, model = _pair(arch_id, reference=True)
    loss_fn, stream, opt = launch_train.lm_setup(model.cfg, batch, seq, steps)
    ours = run(loss_fn, model, stream, opt, LoopConfig(n_steps=steps, log_every=1))
    jopt_cfg = jopt.OptimizerConfig(kind="adamw", lr=3e-4, schedule="warmup_cosine",
                                    warmup_steps=10, total_steps=steps)
    assert dataclasses.asdict(opt) == dataclasses.asdict(jopt_cfg)
    theirs = jloop.run(lambda p_, b: jm.loss(p_, b["tokens"], b["targets"]), params,
                       JDeterministicStream(jlm_stream(jm.cfg, batch, seq), 0), jopt_cfg,
                       jloop.LoopConfig(n_steps=steps, log_every=1))
    assert [s for s, _ in ours["history"]] == list(range(steps))
    np.testing.assert_allclose([m["loss"] for _, m in ours["history"]],
                               [m["loss"] for _, m in theirs["history"]], **LOSS["float32"])
    assert ours["history"][-1][1]["loss"] < ours["history"][0][1]["loss"] + 0.05
    _assert_trees_close(export_lm_params(model),
                        jax.tree_util.tree_map(np.asarray, theirs["state"]["params"]),
                        FP32_REL)


def test_lm_stream_and_settings_are_the_reference_launchers():
    cfg = registry.get("qwen3-8b").SMOKE
    ours, theirs = launch_train.lm_stream(cfg, 3, 9), jlm_stream(cfg, 3, 9)
    for seed in (0, 1, 17):
        a, b = ours(seed), theirs(seed)
        assert sorted(a) == sorted(b) == ["targets", "tokens"]
        for k in a:
            assert a[k].dtype == np.int32 and a[k].shape == (3, 9)
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a["tokens"][:, 1:], a["targets"][:, :-1])


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_train_launcher_trains_each_lm_arch_on_the_cpu(arch_id, capsys):
    out = launch_train.main(["--arch", arch_id, "--device", "cpu", "--steps", "2", "--seq",
                             "16", "--batch", "2"])
    assert out["stopped_at"] == 2 and np.isfinite(out["history"][-1][1]["loss"])
    assert isinstance(out["state"]["model"], LMModel)
    printed = capsys.readouterr().out
    assert f"{arch_id} [lm] SMOKE on cpu" in printed and "finished at step 2" in printed


def test_lm_resume_after_preempt_is_bit_identical():
    """deepseek-moe-16b (MoE aux loss, a dense first block): a run preempted
    after step 2 and restarted from its checkpoint ends with the bits of an
    uninterrupted 5-step run, parameters and AdamW moments; then the
    launcher's ``--ckpt`` and ``--compress``."""
    arch_id = "deepseek-moe-16b"
    loop = lambda d: LoopConfig(n_steps=5, log_every=1, ckpt_every=2, ckpt_dir=d)

    def setup():
        model = _pair(arch_id)[2]
        return (model, *launch_train.lm_setup(model.cfg, 2, 16, 5))

    with tempfile.TemporaryDirectory() as d1, tempfile.TemporaryDirectory() as d2:
        model, loss_fn, stream, opt = setup()
        whole = run(loss_fn, model, stream, opt, loop(d1))
        ev = threading.Event()
        model, loss_fn, stream, opt = setup()
        first = run(loss_fn, model, stream, opt, loop(d2), preempt_event=ev,
                    log_fn=lambda s, m: ev.set() if s == 1 else None)
        assert first["stopped_at"] == 2 and ck.latest_step(d2) == 2
        model, loss_fn, stream, opt = setup()
        second = run(loss_fn, model, stream, opt, loop(d2))
        assert second["stopped_at"] == 5 and [s for s, _ in second["history"]] == [2, 3, 4]
        a, b = whole["state"], second["state"]
        for (k, x), (_, y) in zip(a["model"].state_dict().items(),
                                  b["model"].state_dict().items()):
            assert torch.equal(x, y), k
        for moment in ("m", "v"):
            for k, v in a["opt"][moment].items():
                assert torch.equal(v, b["opt"][moment][k]), (moment, k)
        assert whole["history"][-1][1]["loss"] == second["history"][-1][1]["loss"]
    with tempfile.TemporaryDirectory() as d:
        argv = ["--arch", arch_id, "--device", "cpu", "--seq", "8", "--batch", "2",
                "--ckpt", d, "--compress", "int8"]
        assert launch_train.main(argv + ["--steps", "2"])["stopped_at"] == 2
        assert ck.latest_step(d) == 2
        out = launch_train.main(argv + ["--steps", "3"])
        assert out["stopped_at"] == 3 and [s for s, _ in out["history"]] == [2]


# ---------------------------------------------------------------------------
# model flops and PReLU
# ---------------------------------------------------------------------------
CELLS = ([(a, s, v) for a in LM_IDS for s in registry.LM_SHAPES for v in ("baseline", "sdim_kv")]
         + [(a, s, "baseline") for a in RECSYS_IDS for s in registry.RECSYS_SHAPES])


@pytest.mark.parametrize("arch_id,shape,variant", CELLS, ids=["-".join(c) for c in CELLS])
def test_model_flops_match_the_reference(arch_id, shape, variant):
    assert flops.model_flops(arch_id, shape, variant) == jflops.model_flops(arch_id, shape,
                                                                            variant)


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_lm_parameter_counts_match_the_reference(arch_id):
    """Active and total parameters of FULL; for the dense archs the total
    is the port's model's own count of matrices (``device="meta"``)."""
    cfg, jcfg = registry.get(arch_id).FULL, jregistry.get(arch_id).FULL
    assert flops._lm_active_params(cfg) == jflops._lm_active_params(jcfg)
    assert flops._lm_total_params(cfg) == jflops._lm_total_params(jcfg)
    if cfg.moe is None:                 # the count leaves out norms (and biases)
        params = list(LMModel(cfg, device="meta").parameters())
        assert sum(p.numel() for p in params if p.ndim > 1) == flops._lm_total_params(cfg)


def test_the_models_chip_smoke_trains_have_its_parameter_counts():
    """Phase 15's models on ``device="meta"``: granite-3-2b FULL,
    deepseek-moe-16b cut to 4 layers, deepseek-v2-236b cut to 2."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT,
                                                                           "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    count = lambda arch_id, **over: sum(p.numel() for p in LMModel(
        dataclasses.replace(registry.get(arch_id).FULL, **over), device="meta").parameters())
    assert count("granite-3-2b") == smoke.LMT_GRANITE_PARAMS
    assert count("deepseek-moe-16b", n_layers=smoke.LMT_MOE_LAYERS) == smoke.LMT_MOE_PARAMS
    assert (count("deepseek-v2-236b", n_layers=smoke.LMT_V2_LAYERS)
            == smoke.MOE_PARAMS["deepseek-v2-236b"])
    assert registry.get("granite-3-2b").FULL.remat == "full"


def test_model_flops_of_the_gnn_waits_for_its_slice():
    """The GNN slice has come: gatedgcn's count equals the reference's."""
    assert registry.GNN_SHAPES == jregistry.GNN_SHAPES
    assert registry.RECSYS_SHAPES == jregistry.RECSYS_SHAPES
    assert flops.model_flops("gatedgcn", "molecule") == jflops.model_flops("gatedgcn", "molecule")


def test_prelu_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 5, 12)).astype(np.float32)
    x[0, 0, :3] = 0.0
    jprelu = jlayers.PReLU(12)
    p = jprelu.init(jax.random.PRNGKey(0))
    prelu = PReLU(12, device="cpu")
    np.testing.assert_array_equal(prelu.alpha.detach().numpy(), np.asarray(p["alpha"]))
    alpha = rng.standard_normal(12).astype(np.float32)
    with torch.no_grad():
        prelu.alpha.copy_(_t(alpha))
    xt = _t(x).requires_grad_()
    out = prelu(xt)
    out.sum().backward()
    f = lambda xx, a: jprelu.apply({"alpha": a}, xx)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(f(jnp.asarray(x), alpha)),
                               atol=1e-6, rtol=1e-6)
    jgx, jga = jax.grad(lambda xx, a: jnp.sum(f(xx, a)), argnums=(0, 1))(jnp.asarray(x),
                                                                        jnp.asarray(alpha))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(prelu.alpha.grad.numpy(), np.asarray(jga), atol=1e-5, rtol=1e-5)
