"""Port parity, LM decode with exact and SDIM-compressed KV: ``repro_torch``
against the JAX package on the CPU.

Module level: ``core/sdim.kv_bucket_table``, the in-place
``kv_bucket_fold`` and ``sdim_decode_attention`` (``"l2"``, through
``sdim_query``'s plain version here, and ``"count"``) on the reference's
own q, k and v drawn with ``kernels/screen.py::screened_normal``, so that
both frameworks hash every row to the same bucket; the port's kernel
layout (one table a kv head, its query heads as the candidates) against
the reference's ``jnp.repeat`` layout. Model level, for granite-3-2b,
qwen3-8b, command-r-plus-104b, deepseek-moe-16b (MoE) and deepseek-v2-236b
(MLA and MoE) at SMOKE from the JAX init: 8 tokens (B = 2) through
``decode_step`` and ``sdim_decode_step``, logits at every step and the
final caches (the dense blocks' too), and ``encode_sdim_cache_from_kv`` of
the exact cache. For MLA the SDIM tables hold the latent c_kv (key and
value), one table a layer, read by the absorbed queries of all heads.
The reference's SDIM functions skip the ``first_k_dense`` blocks
(ROADMAP.md, fault C6), and so do the port's:
``test_sdim_decode_skips_the_dense_blocks_c6`` pins it in both packages,
and the incremental tables of the first scanned layer equal the offline
encode of an exact cache only where the dense blocks pass their input
through (their output projections zeroed). q and k come out of different
GEMMs in the two frameworks, so a projection within rounding of 0 could
hash to another bucket: each case's
seed (named in ``SEEDS``) was chosen so that every key and query the
port hashes clears ``screen.clears_margin`` at 1e-4 (asserted; the two
frameworks' q and k differ by ~1e-6 relative at SMOKE), and the count
tables ``ct`` must then equal the reference's exactly. The JAX side runs
under ``jax.jit`` once per arch (module-scoped fixtures).

Tolerances: fp32 atol 1e-5 / rtol 1e-5 per module and for caches (the
reference's own, ``tests/test_kernels.py:46-58``); atol 1e-4 / rtol 1e-4
for model logits; ``ct`` exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import sdim as jsdim
from repro.models.lm import LMModel as JLMModel
from repro_torch.configs import registry
from repro_torch.core import sdim
from repro_torch.kernels.screen import clears_margin, screened_normal
from repro_torch.models.lm import LMModel
from repro_torch.weights import load_jax_lm_params

FP32 = dict(atol=1e-5, rtol=1e-5)
MODEL = dict(atol=1e-4, rtol=1e-4)
HASH_MARGIN = 1e-4
# JAX init key and token seed per arch: every key and query the port hashes
# over the 8 tokens (both paths) clears HASH_MARGIN
SEEDS = {"granite-3-2b": 69, "qwen3-8b": 18, "command-r-plus-104b": 9,
         "deepseek-moe-16b": 0, "deepseek-v2-236b": 5}
B, N_TOKENS = 2, 8


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------
def _kv(seed, S=24, H=2, d=16, m=48):
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((m, d)).astype(np.float32)
    k = screened_normal(rng, (B, S, H, d), R)
    v = rng.standard_normal((B, S, H, d)).astype(np.float32)
    return rng, R, k, v


@pytest.mark.parametrize("masked", [False, True])
def test_kv_bucket_table_matches_jax(masked):
    rng, R, k, v = _kv(0)
    mask = None
    if masked:
        mask = (rng.random((B, k.shape[1])) > 0.3).astype(np.float32)
        mask[1] = 0                                           # a wholly masked row
    jvt, jct = jsdim.kv_bucket_table(jnp.asarray(k), jnp.asarray(v),
                                     None if mask is None else jnp.asarray(mask),
                                     jnp.asarray(R), 3)
    vt, ct = sdim.kv_bucket_table(_t(k), _t(v), None if mask is None else _t(mask), _t(R), 3)
    assert vt.shape == (B, 2, 16, 8, 16) and ct.shape == (B, 2, 16, 8)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(jct))
    np.testing.assert_allclose(vt.numpy(), np.asarray(jvt), **FP32)


def test_kv_bucket_fold_equals_the_reference_s_per_token_sum():
    """Row by row into zero tables, as a decode folds: the reference adds
    ``kv_bucket_table`` of each row (``lm.py:277-278``)."""
    _, R, k, v = _kv(1, S=12)
    jvt, jct = jnp.zeros((B, 2, 16, 8, 16)), jnp.zeros((B, 2, 16, 8))
    vt, ct = torch.zeros((B, 2, 16, 8, 16)), torch.zeros((B, 2, 16, 8))
    for s in range(k.shape[1]):
        dvt, dct = jsdim.kv_bucket_table(jnp.asarray(k[:, s:s + 1]), jnp.asarray(v[:, s:s + 1]),
                                         None, jnp.asarray(R), 3)
        jvt, jct = jvt + dvt, jct + dct
        sdim.kv_bucket_fold(vt, ct, _t(k[:, s]), _t(v[:, s]), _t(R), 3)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(jct))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(jvt))    # x + v, one hit a cell


@pytest.mark.parametrize("normalize", ["l2", "count"])
@pytest.mark.parametrize("T", [1, 3])
def test_sdim_decode_attention_matches_jax(normalize, T):
    """q (B, T, H = 4, d) against tables of 2 kv heads: the reference
    repeats each table to its 2 query heads; the port does not."""
    rng, R, k, v = _kv(2)
    q = screened_normal(rng, (B, T, 4, 16), R)
    jvt, jct = jsdim.kv_bucket_table(jnp.asarray(k), jnp.asarray(v), None, jnp.asarray(R), 3)
    want = jsdim.sdim_decode_attention(jnp.asarray(q), jnp.repeat(jvt, 2, axis=1),
                                       jnp.repeat(jct, 2, axis=1), jnp.asarray(R), 3,
                                       normalize)
    got = sdim.sdim_decode_attention(_t(q), _t(jvt), _t(jct), _t(R), 3, normalize)
    assert got.shape == (B, T, 4, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


@pytest.mark.parametrize("normalize", ["l2", "count"])
def test_kernel_layout_equals_the_repeat_layout(normalize):
    """One table a kv head with its query heads as the candidates (what
    ``sdim_query`` gets) against the tables repeated per query head."""
    rng, R, k, v = _kv(3)
    q = screened_normal(rng, (B, 1, 4, 16), R)
    vt, ct = sdim.kv_bucket_table(_t(k), _t(v), None, _t(R), 3)
    grouped = sdim.sdim_decode_attention(_t(q), vt, ct, _t(R), 3, normalize)
    repeated = sdim.sdim_decode_attention(_t(q), vt.repeat_interleave(2, dim=1),
                                          ct.repeat_interleave(2, dim=1), _t(R), 3, normalize)
    np.testing.assert_allclose(grouped.numpy(), repeated.numpy(), **FP32)
    with pytest.raises(ValueError, match="sdim_decode_attention"):
        sdim.sdim_decode_attention(_t(q)[:, :, :3], vt, ct, _t(R), 3)
    with pytest.raises(ValueError, match="normalize"):
        sdim.sdim_decode_attention(_t(q), vt, ct, _t(R), 3, "softmax")


# ---------------------------------------------------------------------------
# the model: 8 tokens through both decode paths
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=list(SEEDS))
def case(request):
    """The JAX side of one arch, run once: params, R, tokens, logits of
    every step of both paths, the final caches and the offline encode."""
    arch_id = request.param
    seed = SEEDS[arch_id]
    jm = JLMModel(jregistry.get(arch_id).SMOKE)
    params = jm.init(jax.random.PRNGKey(seed))
    toks = np.random.default_rng(seed).integers(0, jm.cfg.vocab, (B, N_TOKENS)).astype(np.int32)
    exact, compressed = jax.jit(jm.decode_step), jax.jit(jm.sdim_decode_step)
    cache, scache = jm.init_cache(B, N_TOKENS, jnp.float32), jm.init_sdim_cache(B)
    logits, slogits = [], []
    for i in range(N_TOKENS):
        lg, cache = exact(params, jnp.asarray(toks[:, i:i + 1]), cache, i)
        slg, scache = compressed(params, jnp.asarray(toks[:, i:i + 1]), scache)
        logits.append(np.asarray(lg))
        slogits.append(np.asarray(slg))
    mask = np.ones((B, N_TOKENS), np.float32)
    mask[1, 5:] = 0
    return dict(arch_id=arch_id, seed=seed, toks=toks, R=np.asarray(jm._sdim_R()),
                params=jax.tree_util.tree_map(np.asarray, params),
                logits=logits, slogits=slogits,
                cache=jax.tree_util.tree_map(np.asarray, cache),
                scache=jax.tree_util.tree_map(np.asarray, scache), mask=mask,
                encoded=jax.tree_util.tree_map(np.asarray, jax.jit(jm.encode_sdim_cache_from_kv)(
                    cache)),
                encoded_masked=jax.tree_util.tree_map(
                    np.asarray, jax.jit(jm.encode_sdim_cache_from_kv)(cache, jnp.asarray(mask))))


def _port(case):
    model = LMModel(registry.get(case["arch_id"]).SMOKE, device="cpu")
    return load_jax_lm_params(model, case["params"], case["R"])


def _port_cache(cache: dict) -> dict:
    """The port's layout of one exact cache of the reference: GQA's k and v
    head-major (its head axis before the rows), MLA's ckv and krope as
    they are."""
    if "ckv" in cache:
        return cache
    return {k: v.swapaxes(-2, -3) for k, v in cache.items()}


def _keys(cache: dict) -> np.ndarray:
    """The rows an exact cache's keys hash: GQA's k, MLA's latent."""
    t = cache["ckv"] if "ckv" in cache else cache["k"]
    return np.asarray(t).reshape(-1, t.shape[-1])


@torch.no_grad()
def _pass_through_dense_blocks(model) -> None:
    """Zero the dense blocks' output projections: each then adds nothing to
    the residual, so the first scanned layer sees the embeddings, as it
    does on the SDIM path (which skips the dense blocks, C6)."""
    from repro_torch.nn.moe import MoELayer

    for block in model.dense_blocks:
        block.attn.wo.weight.zero_()
        assert not isinstance(block.ffn, MoELayer)
        block.ffn.wo.weight.zero_()


def _recording(monkeypatch, hashed: list):
    """Record every key the SDIM path folds and every query it reads with."""
    fold, attend = sdim.kv_bucket_fold, sdim.sdim_decode_attention

    def rec_fold(vt, ct, k, v, R, tau):
        hashed.append(k.numpy().reshape(-1, k.shape[-1]))
        fold(vt, ct, k, v, R, tau)

    def rec_attend(q, *args, **kw):
        hashed.append(q.numpy().reshape(-1, q.shape[-1]))
        return attend(q, *args, **kw)

    monkeypatch.setattr(sdim, "kv_bucket_fold", rec_fold)
    monkeypatch.setattr(sdim, "sdim_decode_attention", rec_attend)


@torch.no_grad()
def test_decode_step_matches_jax(case):
    model = _port(case)
    cache = model.init_cache(B, N_TOKENS, torch.float32)
    k_buf = next(iter(cache["stack"].values()))
    for i in range(N_TOKENS):
        logits, cache = model.decode_step(_t(case["toks"][:, i:i + 1]), cache, i)
        np.testing.assert_allclose(logits.numpy(), case["logits"][i], **MODEL,
                                   err_msg=f"step {i}")
    assert next(iter(cache["stack"].values())) is k_buf      # written in place
    want = _port_cache(case["cache"]["stack"])                # GQA: head-major
    assert set(cache["stack"]) == set(want)
    for name, t in cache["stack"].items():
        np.testing.assert_allclose(t.numpy(), want[name], **FP32)
    assert len(cache.get("dense", [])) == len(case["cache"].get("dense", []))
    for got, jc in zip(cache.get("dense", []), case["cache"].get("dense", [])):
        for name, t in got.items():
            np.testing.assert_allclose(t.numpy(), _port_cache(jc)[name], **FP32)


@torch.no_grad()
def test_sdim_decode_step_matches_jax(case, monkeypatch):
    model = _port(case)
    hashed = []
    _recording(monkeypatch, hashed)
    scache = model.init_sdim_cache(B)
    assert scache["vt"].shape == case["scache"]["vt"].shape
    for i in range(N_TOKENS):
        logits, scache = model.sdim_decode_step(_t(case["toks"][:, i:i + 1]), scache)
        np.testing.assert_allclose(logits.numpy(), case["slogits"][i], **MODEL,
                                   err_msg=f"step {i}")
    hashed = np.concatenate(hashed)
    cfg = model.cfg
    key_heads = 1 if cfg.attention == "mla" else cfg.n_kv_heads    # MLA: the latent
    assert len(hashed) == N_TOKENS * cfg.n_scan_layers * B * (key_heads + cfg.n_heads)
    assert clears_margin(hashed, case["R"], HASH_MARGIN).all(), f"seed {case['seed']}"
    assert scache["len"] == N_TOKENS == int(case["scache"]["len"])
    np.testing.assert_array_equal(scache["ct"].numpy(), case["scache"]["ct"])
    np.testing.assert_allclose(scache["vt"].numpy(), case["scache"]["vt"], **FP32)


@torch.no_grad()
def test_encode_sdim_cache_from_kv_matches_jax(case):
    """The offline pass over the exact cache (whose keys clear the margin
    too), with and without a mask; its first scanned layer equals the
    incremental path's where that layer sees the same inputs on both paths
    (with ``first_k_dense``, after the dense blocks are made to pass their
    input through: the SDIM path skips them, C6)."""
    model = _port(case)
    cache = {"stack": {k: _t(v) for k, v in _port_cache(case["cache"]["stack"]).items()}}
    assert clears_margin(_keys(case["cache"]["stack"]), case["R"], HASH_MARGIN).all(), \
        f"seed {case['seed']}"
    for mask, want in ((None, case["encoded"]), (case["mask"], case["encoded_masked"])):
        got = model.encode_sdim_cache_from_kv(cache, None if mask is None else _t(mask))
        np.testing.assert_array_equal(got["ct"].numpy(), want["ct"])
        np.testing.assert_allclose(got["vt"].numpy(), want["vt"], **FP32)
    full = model.encode_sdim_cache_from_kv(cache)
    again = model.encode_sdim_cache_from_kv(cache)
    assert again["vt"].equal(full["vt"]) and again["ct"].equal(full["ct"])   # same bits twice
    if model.cfg.first_k_dense:
        _pass_through_dense_blocks(model)
        cache = model.init_cache(B, N_TOKENS, torch.float32)
        for i in range(N_TOKENS):
            model.decode_step(_t(case["toks"][:, i:i + 1]), cache, i)
        assert clears_margin(_keys({k: v.numpy() for k, v in cache["stack"].items()}),
                             case["R"], HASH_MARGIN).all(), f"seed {case['seed']}"
        full = model.encode_sdim_cache_from_kv(cache)
    scache = model.init_sdim_cache(B)
    for i in range(N_TOKENS):
        model.sdim_decode_step(_t(case["toks"][:, i:i + 1]), scache)
    np.testing.assert_array_equal(scache["ct"][0].numpy(), full["ct"][0].numpy())
    np.testing.assert_allclose(scache["vt"][0].numpy(), full["vt"][0].numpy(), **FP32)


@pytest.mark.parametrize("arch_id", ["deepseek-moe-16b", "deepseek-v2-236b"])
def test_sdim_decode_skips_the_dense_blocks_c6(arch_id):
    """Fault C6 of the reference, copied on purpose: with every parameter
    of the ``first_k_dense`` blocks set to 1.7, SDIM decode gives the same
    logits in both packages (the blocks are never run) while exact decode
    moves; the port's logits match the reference's either way."""
    seed = SEEDS[arch_id]
    jm = JLMModel(jregistry.get(arch_id).SMOKE)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    moved = dict(params, dense_blocks=jax.tree_util.tree_map(lambda a: np.full_like(a, 1.7),
                                                             params["dense_blocks"]))
    toks = np.random.default_rng(seed).integers(0, jm.cfg.vocab, (B, 4)).astype(np.int32)
    R = np.asarray(jm._sdim_R())
    exact, compressed = jax.jit(jm.decode_step), jax.jit(jm.sdim_decode_step)
    out = {}
    for name, p in (("original", params), ("moved", moved)):
        model = load_jax_lm_params(LMModel(registry.get(arch_id).SMOKE, device="cpu"), p, R)
        jc, jsc = jm.init_cache(B, 4, jnp.float32), jm.init_sdim_cache(B)
        c, sc = model.init_cache(B, 4, torch.float32), model.init_sdim_cache(B)
        runs = {k: [] for k in ("jexact", "jsdim", "exact", "sdim")}
        for i in range(4):
            t = toks[:, i:i + 1]
            lg, jc = exact(p, jnp.asarray(t), jc, i)
            slg, jsc = compressed(p, jnp.asarray(t), jsc)
            runs["jexact"].append(np.asarray(lg))
            runs["jsdim"].append(np.asarray(slg))
            with torch.no_grad():
                runs["exact"].append(model.decode_step(_t(t), c, i)[0].numpy())
                runs["sdim"].append(model.sdim_decode_step(_t(t), sc)[0].numpy())
        out[name] = {k: np.stack(v) for k, v in runs.items()}
        np.testing.assert_allclose(out[name]["exact"], out[name]["jexact"], **MODEL)
        np.testing.assert_allclose(out[name]["sdim"], out[name]["jsdim"], **MODEL)
    a, b = out["original"], out["moved"]
    for key in ("jsdim", "sdim"):
        np.testing.assert_array_equal(a[key], b[key])        # unchanged: C6
    for key in ("jexact", "exact"):
        assert np.isfinite(b[key]).all() and np.abs(a[key] - b[key]).max() > 0.1
