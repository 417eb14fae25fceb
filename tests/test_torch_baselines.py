"""Port parity, the Table 2/3 baselines: ``repro_torch``'s SRHT hash
family, the gather and expectation forms of SDIM and the interest kinds
``avg``, ``sim_hard``, ``eta``, ``ubr4ctr``, ``din_mlp`` and
``sdim_expected`` against the JAX package on the CPU.

Inputs come from numpy seeds. The JAX side runs as its own tests run it
(the XLA formulation; no kernel is involved in these kinds), and its
initial parameters and hash matrices cross into the port. Inputs that a
hash decides are margin-screened (``kernels.screen``): every projection
clears 1e-3·‖r‖‖x‖, so both packages agree on every signature bit; for
``ubr4ctr`` the k-th and (k+1)-th retrieval scores of every candidate are
apart by more than 1e-3 of the largest, or exactly equal (``topk_clear``).
ETA's scores are integers, equal in both packages once the bits agree,
and both break their ties by index.

Tolerances: fp32 atol 1e-5 / rtol 1e-5, the reference's own
(tests/test_kernels.py); the SRHT dense matrix is compared bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sdim as jsdim
from repro.core import simhash as jsimhash
from repro.core.interest import InterestConfig as JInterestConfig
from repro.core.interest import InterestModule as JInterestModule
from repro_torch.core import retrieval, sdim, simhash
from repro_torch.core.engine import EngineConfig, SDIMEngine, make_hash_family
from repro_torch.core.interest import INTEREST_KINDS, InterestConfig, InterestModule
from repro_torch.kernels.screen import screened_normal, topk_clear

FP32 = dict(atol=1e-5, rtol=1e-5)
B, L, C, D, M, TAU, K = 4, 48, 5, 32, 12, 2, 8
KINDS = ["avg", "sim_hard", "eta", "ubr4ctr", "din_mlp", "sdim_expected"]


def _t(x, **kw):
    return torch.tensor(np.asarray(x), **kw)


# ---------------------------------------------------------------------------
# SRHT
# ---------------------------------------------------------------------------
def _srht_pair(d, m=48, seed=0):
    h = jsimhash.srht_hashes(jax.random.PRNGKey(seed), m, d)
    ours = simhash.SRHTHashes(d1=_t(h.d1), d2=_t(h.d2), rows=_t(h.rows).long(),
                              d=h.d, d_pad=h.d_pad)
    return h, ours


@pytest.mark.parametrize("d", [16, 48, 128])
def test_srht_matches_jax(d):
    """fwht and project at fp32 tolerance; dense_matrix bit for bit (its
    entries are integers of magnitude <= d_pad)."""
    h, ours = _srht_pair(d)
    x = np.random.default_rng(d).standard_normal((3, 7, d)).astype(np.float32)
    xp = np.random.default_rng(d + 1).standard_normal((3, h.d_pad)).astype(np.float32)
    np.testing.assert_allclose(simhash.fwht(_t(xp)).numpy(),
                               np.asarray(jsimhash.fwht(jnp.asarray(xp))), **FP32)
    np.testing.assert_allclose(ours.project(_t(x)).numpy(),
                               np.asarray(h.project(jnp.asarray(x))), **FP32)
    np.testing.assert_array_equal(ours.codes(_t(x)).numpy(), np.asarray(h.codes(jnp.asarray(x))))
    np.testing.assert_array_equal(simhash.srht_signatures(_t(x), ours, 3).numpy(),
                                  np.asarray(jsimhash.srht_signatures(jnp.asarray(x), h, 3)))
    dense = ours.dense_matrix().numpy()
    assert dense.shape == (48, d) and dense.dtype == np.float32
    assert np.array_equal(dense, np.asarray(h.dense_matrix()))


def test_srht_family_of_the_engine():
    """The port's own SRHT draw: ±1 signs, m distinct rows of d_pad, and an
    engine R that is its dense matrix, whose signs are the family's codes."""
    gen = torch.Generator().manual_seed(1234)
    h = simhash.srht_hashes(gen, 48, 128)
    assert h.d_pad == 128 and set(h.d1.tolist()) <= {-1.0, 1.0}
    assert set(h.d2.tolist()) <= {-1.0, 1.0}
    assert len(set(h.rows.tolist())) == 48 and int(h.rows.max()) < 128
    cfg = EngineConfig(m=48, tau=3, d=128, family="srht")
    R = make_hash_family(cfg, torch.device("cpu"))
    assert torch.equal(R, h.dense_matrix())
    x = torch.from_numpy(screened_normal(np.random.default_rng(0), (64, 128), R.numpy()))
    assert torch.equal(simhash.hash_codes(x, R), h.codes(x))
    assert torch.equal(SDIMEngine(cfg, device="cpu").R, R)
    with pytest.raises(ValueError):
        make_hash_family(dataclasses.replace(cfg, family="gaussian"), torch.device("cpu"))


def test_collision_expectation_matches_jax():
    c = np.linspace(-1.2, 1.2, 41).astype(np.float32)
    np.testing.assert_allclose(simhash.collision_expectation(_t(c), 3).numpy(),
                               np.asarray(jsimhash.collision_expectation(jnp.asarray(c), 3)),
                               **FP32)


# ---------------------------------------------------------------------------
# SDIM's gather and expectation forms
# ---------------------------------------------------------------------------
def _history(rng, R, b=B, l=L, d=D):
    """Screened behaviors (b, l, d) and a ragged mask with user 1 fully
    masked."""
    seq = screened_normal(rng, (b, l, d), R)
    lengths = rng.integers(l // 4, l + 1, b)
    lengths[1] = 0
    mask = (np.arange(l)[None] >= (l - lengths[:, None])).astype(np.float32)
    return seq, mask


@pytest.mark.parametrize("family", ["dense", "srht"])
@pytest.mark.parametrize("single", [True, False])
def test_sdim_attention_gather_matches_bucket_form(single, family):
    """The literal Eq. 9/11/12 gather equals the bucket form in both
    packages, and the port's equals the JAX package's."""
    rng = np.random.default_rng(3)
    key = jax.random.PRNGKey(7)
    R = np.asarray(jsimhash.make_hashes(key, M, D) if family == "dense"
                   else jsimhash.srht_hashes(key, M, D).dense_matrix())
    seq, mask = _history(rng, R)
    q = screened_normal(rng, (B, D) if single else (B, C, D), R)
    args = (jnp.asarray(q), jnp.asarray(seq), jnp.asarray(mask), jnp.asarray(R))
    theirs = np.asarray(jsdim.sdim_attention_gather(*args, TAU))
    np.testing.assert_allclose(np.asarray(jsdim.sdim_attention(*args, TAU)), theirs, **FP32)
    targs = (_t(q), _t(seq), _t(mask), _t(R))
    ours = sdim.sdim_attention_gather(*targs, TAU)
    np.testing.assert_allclose(ours.numpy(), theirs, **FP32)
    np.testing.assert_allclose(sdim.sdim_attention(*targs, TAU).numpy(), theirs, **FP32)


def test_gather_buckets_and_combine_groups_match_jax():
    rng = np.random.default_rng(4)
    table = rng.standard_normal((B, 6, 4, D)).astype(np.float32)
    table[1] = 0.0
    for shape in ((B, 6), (B, C, 6)):
        sig = rng.integers(0, 4, shape).astype(np.int32)
        theirs = np.asarray(jsdim.gather_buckets(jnp.asarray(table), jnp.asarray(sig)))
        ours = sdim.gather_buckets(_t(table), _t(sig))
        np.testing.assert_allclose(ours.numpy(), theirs, **FP32)
        np.testing.assert_allclose(sdim.combine_groups(ours).numpy(),
                                   np.asarray(jsdim.combine_groups(jnp.asarray(theirs))), **FP32)


# ---------------------------------------------------------------------------
# top-k order
# ---------------------------------------------------------------------------
def test_top_k_breaks_ties_as_lax_top_k():
    """Tied and -inf scores: the port's top-k picks and orders the rows as
    ``jax.lax.top_k`` does (``torch.topk`` does not)."""
    s = np.array([1, 3, 3, -np.inf, 3, -np.inf, -np.inf], np.float32)
    v, i = retrieval.top_k(_t(s), 5)
    jv, ji = jax.lax.top_k(jnp.asarray(s), 5)
    assert i.tolist() == np.asarray(ji).tolist() == [1, 2, 4, 0, 3]
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    rng = np.random.default_rng(5)
    s = rng.integers(0, 5, (3, 4, 40)).astype(np.float32)
    s[rng.random(s.shape) < 0.4] = -np.inf
    s[0, 0] = -np.inf
    v, i = retrieval.top_k(_t(s), 16)
    jv, ji = jax.lax.top_k(jnp.asarray(s), 16)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    with pytest.raises(ValueError):
        retrieval.top_k(_t(s), 41)


def test_topk_clear():
    """Apart by more than the margin, or exactly tied (equal inputs), is
    clear; a gap within the margin is not."""
    s = np.array([[3.0, 2.0, 2.0, 1.0], [3.0, 2.0, 2.0 - 1e-9, 1.0], [3.0, 2.0, 1.0, 0.0],
                  [3.0, 2.0, -np.inf, -np.inf], [3.0, -np.inf, -np.inf, -np.inf]])
    assert topk_clear(s, 2).tolist() == [True, False, True, True, True]
    assert topk_clear(s[:, :2], 2).all()


# ---------------------------------------------------------------------------
# the interest kinds
# ---------------------------------------------------------------------------
def _modules(kind, seed=0):
    """(port module, JAX module, JAX params) with the JAX init carried over."""
    jcfg = JInterestConfig(kind=kind, d=D, m=M, tau=TAU, top_k=K, backend="xla")
    jmod = JInterestModule(jcfg)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(seed)))
    ours = InterestModule(InterestConfig(kind=kind, d=D, m=M, tau=TAU, top_k=K), device="cpu")
    with torch.no_grad():
        if kind == "eta":
            ours.R.copy_(_t(params["buffers"]["R"]))
        elif kind == "din_mlp":
            for name, p in params["mlp"].items():
                layer = getattr(ours.din.mlp, name)
                layer.weight.copy_(_t(p["w"]).T)
                layer.bias.copy_(_t(p["b"]))
        elif kind == "ubr4ctr":
            ours.ubr.wq.weight.copy_(_t(params["wq"]["w"]).T)
            ours.ubr.wk.weight.copy_(_t(params["wk"]["w"]).T)
    return ours, jmod, params


def _inputs(kind, single, params, seed=1):
    """q, seq, mask (ragged; user 1 fully masked), seq_cat, q_cat as numpy;
    hash-screened against ETA's R, top-k-screened for UBR4CTR."""
    rng = np.random.default_rng(seed)
    R = params["buffers"]["R"] if kind == "eta" else rng.standard_normal((M, D)).astype(np.float32)
    qshape = (B, D) if single else (B, C, D)
    seq, mask = _history(rng, R)
    q = screened_normal(rng, qshape, R)
    if kind == "ubr4ctr":
        wq, wk = (np.asarray(params[w]["w"], np.float64) for w in ("wq", "wk"))
        for _ in range(100):
            qc = q[:, None] if single else q
            sc = np.einsum("bcp,blp->bcl", qc @ wq, seq @ wk)
            sc = np.where(mask[:, None] > 0, sc, -np.inf)
            bad = ~topk_clear(sc, K).all(axis=-1)
            if not bad.any():
                break
            seq[bad] = screened_normal(rng, seq[bad].shape, R)
        assert not bad.any()
    seq_cat = rng.integers(0, 4, (B, L)).astype(np.int32)
    q_cat = rng.integers(0, 5, qshape[:-1]).astype(np.int32)
    return q, seq, mask, seq_cat, q_cat


@pytest.mark.parametrize("single", [True, False], ids=["B,d", "B,C,d"])
@pytest.mark.parametrize("kind", KINDS)
def test_interest_kind_forward_and_gradients_match_jax(kind, single):
    """Forward at (B, d) and (B, C, d) with ragged and fully masked users;
    gradients of a random projection of the output in q, seq and the
    kind's parameters against ``jax.grad`` (where it is finite, which it is
    on these inputs); ubr4ctr's projections get exactly zero in both."""
    ours, jmod, params = _modules(kind)
    q, seq, mask, seq_cat, q_cat = _inputs(kind, single, params)
    w = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)

    def jloss(p, qq, ss):
        out = jmod.apply(p, qq, ss, jnp.asarray(mask), seq_cat=jnp.asarray(seq_cat),
                         q_cat=jnp.asarray(q_cat))
        return jnp.sum(out * jnp.asarray(w)), out

    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jparams, jnp.asarray(q), jnp.asarray(seq))
    tq, ts = _t(q, requires_grad=True), _t(seq, requires_grad=True)
    out = ours(tq, ts, _t(mask), seq_cat=_t(seq_cat), q_cat=_t(q_cat))
    assert out.shape == q.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **FP32)
    (out * _t(w)).sum().backward()
    jgp, jgq, jgs = jgrads
    for name, ours_g, theirs_g in (("q", tq.grad, jgq), ("seq", ts.grad, jgs)):
        assert np.isfinite(np.asarray(theirs_g)).all()
        got = np.zeros(q.shape if name == "q" else seq.shape, np.float32) if ours_g is None \
            else ours_g.numpy()
        np.testing.assert_allclose(got, np.asarray(theirs_g), err_msg=name, **FP32)
    if kind == "din_mlp":
        for name, p in jgp["mlp"].items():
            layer = getattr(ours.din.mlp, name)
            np.testing.assert_allclose(layer.weight.grad.numpy().T, np.asarray(p["w"]), **FP32)
            np.testing.assert_allclose(layer.bias.grad.numpy(), np.asarray(p["b"]), **FP32)
    if kind == "ubr4ctr":
        for name in ("wq", "wk"):
            assert not np.asarray(jgp[name]["w"]).any()
            assert getattr(ours.ubr, name).weight.grad is None


def test_interest_module_takes_every_kind():
    for kind in INTEREST_KINDS:
        InterestModule(InterestConfig(kind=kind, d=D, m=M, tau=TAU, top_k=K), device="cpu")
    assert set(INTEREST_KINDS) == {"sdim", "sdim_expected", "target", "din_mlp", "avg",
                                   "sim_hard", "eta", "ubr4ctr", "none"}
    with pytest.raises(ValueError):
        InterestModule(InterestConfig(kind="dien", d=D), device="cpu")
    mod = InterestModule(InterestConfig(kind="sim_hard", d=D), device="cpu")
    with pytest.raises(ValueError):
        mod(torch.zeros(2, D), torch.zeros(2, 40, D), None)


def test_din_mlp_chunks_candidates_alike():
    """The candidate chunks of DinActivationUnit give the unchunked
    result."""
    ours, _, _ = _modules("din_mlp")
    rng = np.random.default_rng(2)
    q, seq = _t(rng.standard_normal((B, 9, D)).astype(np.float32)), _t(
        rng.standard_normal((B, L, D)).astype(np.float32))
    mask = _t((rng.random((B, L)) > 0.3).astype(np.float32))
    whole = ours(q, seq, mask)
    ours.din.CHUNK_ELEMS = B * L * 4 * D * 2           # two candidates a chunk
    np.testing.assert_allclose(ours(q, seq, mask).detach().numpy(), whole.detach().numpy(),
                               **FP32)


# ---------------------------------------------------------------------------
# C2: the reference's sdim_expected gradient
# ---------------------------------------------------------------------------
def test_sdim_expected_gradient_is_not_finite_at_a_repeated_item_c2():
    """ROADMAP.md §C, C2 (a fault of the JAX package, recorded, not
    repaired): a candidate equal to one of its user's behaviors has a
    cosine of 1 with it, where the derivative of arccos is infinite, so
    ``jax.grad`` of ``sdim_expected_attention`` is not finite. The port
    gives the same: its clip passes gradients on as ``jnp.clip`` does
    (multiplied by 1, 0.5 or 0, so inf·0 = NaN), where ``torch.clamp``
    would give 0. On exact unit vectors (cosine exactly 1 in both) the
    finite entries agree at fp32 tolerance and the non-finite ones sit at
    the same places."""
    seq = np.zeros((1, 3, 8), np.float32)
    seq[0, 0, 0], seq[0, 1, 1], seq[0, 2, 2] = 1.0, 1.0, 1.0
    q = seq[:, 1].copy()                                    # a repeat of behavior 1
    mask = np.ones((1, 3), np.float32)
    jg = jax.grad(lambda qq, ss: jnp.sum(jsdim.sdim_expected_attention(
        qq, ss, jnp.asarray(mask), TAU)), argnums=(0, 1))(jnp.asarray(q), jnp.asarray(seq))
    tq, ts = _t(q, requires_grad=True), _t(seq, requires_grad=True)
    sdim.sdim_expected_attention(tq, ts, _t(mask), TAU).sum().backward()
    for ours, theirs in ((tq.grad.numpy(), np.asarray(jg[0])), (ts.grad.numpy(), np.asarray(jg[1]))):
        assert not np.isfinite(theirs).all()
        np.testing.assert_array_equal(np.isfinite(ours), np.isfinite(theirs))
        np.testing.assert_array_equal(np.isnan(ours), np.isnan(theirs))
        fin = np.isfinite(theirs)
        np.testing.assert_allclose(ours[fin], theirs[fin], **FP32)
