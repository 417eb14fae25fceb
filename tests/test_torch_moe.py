"""Port parity, the mixture-of-experts FFN: ``repro_torch.nn.moe`` against
the JAX package's ``repro/nn/moe.py`` (its one-device path) on the CPU.

``MoELayer._route`` (softmax router probabilities, top-k in
``lax.top_k``'s order, the optional renormalization and
``routed_scaling``, the switch-style aux loss), ``_capacity``,
``dispatch_combine`` (a case where experts overflow their capacity and
drop tokens; owned experts e0 > 0 of E_loc < E, the unowned pairs masked;
the partial outputs of E / E_loc shards summing to the whole) and
``MoELayer`` with and without shared experts, from the JAX package's init
carried across as numpy. The dispatch has no data-dependent shape (it runs
on ``device="meta"``, where ``.item()``, ``nonzero`` and boolean indexing
raise), and the layer gives the same bits twice.

Inputs are numpy from a seed; routing compares indices exactly, so each
case asserts that its k-th and (k+1)-th router probabilities lie apart by
more than rounding (``ROUTE_MARGIN``): two frameworks' router GEMMs could
otherwise pick different experts. Tolerances: fp32 atol 1e-5 / rtol 1e-5
(the reference's own, ``tests/test_kernels.py:46-58``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import moe as jmoe
from repro_torch.nn import moe

FP32 = dict(atol=1e-5, rtol=1e-5)
ROUTE_MARGIN = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


@torch.no_grad()
def _load_experts(ffn, p):
    for name in ("wi_gate", "wi_up", "wo"):
        getattr(ffn, name).copy_(_t(p[name]))


def _pair(seed=0, d=16, f=8, E=8, k=2, n_shared=2, **kw):
    """(JAX layer, its params, the port's layer with them)."""
    jl = jmoe.MoELayer(d_model=d, d_ff=f, n_experts=E, top_k=k, n_shared=n_shared, **kw)
    p = jl.init(jax.random.PRNGKey(seed))
    layer = moe.MoELayer(d, f, E, k, n_shared, device="cpu", **kw)
    with torch.no_grad():
        layer.router.w.copy_(_t(p["router"]["w"]))
    _load_experts(layer.experts, p["experts"])
    if n_shared:
        _load_experts(layer.shared, p["shared"])
    return jl, p, layer


def _routes_apart(probs: np.ndarray, k: int) -> bool:
    """Whether the k-th and (k+1)-th probabilities of every token differ
    by more than ROUTE_MARGIN."""
    s = -np.sort(-probs, axis=-1)
    return probs.shape[-1] == k or bool((s[..., k - 1] - s[..., k] > ROUTE_MARGIN).all())


@pytest.mark.parametrize("norm_topk_prob,routed_scaling", [(False, 1.0), (True, 1.0),
                                                           (False, 2.5), (True, 16.0)])
def test_route_matches_jax(norm_topk_prob, routed_scaling):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 7, 16)).astype(np.float32)
    jl, p, layer = _pair(seed=1, norm_topk_prob=norm_topk_prob, routed_scaling=routed_scaling)
    jprobs, jidx, jw, jaux = jl._route(p, jnp.asarray(x))
    with torch.no_grad():
        probs, idx, w, aux = layer._route(_t(x))
    assert _routes_apart(np.asarray(jprobs), 2)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), **FP32)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **FP32)
    np.testing.assert_allclose(float(aux), float(jaux), **FP32)


def test_route_breaks_ties_as_lax_top_k():
    """Equal probabilities (a zero router): the lower expert id first."""
    jl, p, layer = _pair(seed=2, E=6, k=3)
    with torch.no_grad():
        layer.router.w.zero_()
    p = dict(p, router={"w": jnp.zeros_like(p["router"]["w"])})
    x = np.random.default_rng(2).standard_normal((2, 3, 16)).astype(np.float32)
    _, idx, _, _ = layer._route(_t(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jl._route(p, jnp.asarray(x))[1]))
    assert (idx.numpy() == np.array([0, 1, 2])).all()


@pytest.mark.parametrize("tokens", [1, 2, 24, 64, 2048, 4096])
@pytest.mark.parametrize("E,k,cf", [(8, 2, 1.25), (64, 6, 1.25), (160, 6, 1.25),
                                    (64, 6, 64 / 6)])
def test_capacity_matches_jax(tokens, E, k, cf):
    jl = jmoe.MoELayer(d_model=8, d_ff=4, n_experts=E, top_k=k, capacity_factor=cf)
    layer = moe.MoELayer(8, 4, E, k, capacity_factor=cf, device="meta")
    assert layer._capacity(tokens) == jl._capacity(tokens, 1)
    assert layer._capacity(tokens) % 8 == 0 and layer._capacity(tokens) >= 8


def _dispatch_inputs(seed, T=24, d=16, E=8, k=2, skew=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d)).astype(np.float32)
    if skew:                                  # most tokens pick experts 0 and 1
        idx = np.stack([rng.choice(E, k, replace=False, p=np.r_[[0.4, 0.4],
                                                             [0.2 / (E - 2)] * (E - 2)])
                        for _ in range(T)]).astype(np.int32)
    else:
        idx = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(np.int32)
    w = rng.random((T, k)).astype(np.float32)
    return x, idx, w


def _jdispatch(x, idx, w, p, e0, cap):
    return np.asarray(jmoe.dispatch_combine(jnp.asarray(x), jnp.asarray(idx), jnp.asarray(w),
                                            p, e0, cap, "silu"))


def _drops(idx, E_loc, e0, cap) -> int:
    """(token, choice) pairs of owned experts past their capacity."""
    le = idx.reshape(-1) - e0
    owned = le[(le >= 0) & (le < E_loc)]
    return int(sum(max(0, int((owned == e).sum()) - cap) for e in range(E_loc)))


def test_dispatch_combine_drops_tokens_past_capacity_as_jax():
    x, idx, w = _dispatch_inputs(3, skew=True)
    jl, p, layer = _pair(seed=3)
    cap = 8
    assert _drops(idx, 8, 0, cap) > 0                        # the case drops tokens
    got = moe.dispatch_combine(_t(x), _t(idx), _t(w), layer.experts.weights(), 0, cap, "silu")
    np.testing.assert_allclose(got.detach().numpy(),
                               _jdispatch(x, idx, w, p["experts"], 0, cap), **FP32)
    # a dropped pair contributes nothing: with room for all, the outputs move
    roomy = moe.dispatch_combine(_t(x), _t(idx), _t(w), layer.experts.weights(), 0, 24, "silu")
    assert not np.allclose(roomy.detach().numpy(), got.detach().numpy())


def test_dispatch_combine_of_owned_experts_matches_jax():
    """Experts e0 = 3 .. 5 of 8 (E_loc = 3): the other pairs are unowned."""
    x, idx, w = _dispatch_inputs(4)
    jl, p, layer = _pair(seed=4)
    sl = {name: p["experts"][name][3:6] for name in ("wi_gate", "wi_up", "wo")}
    part = {name: _t(v) for name, v in sl.items()}
    got = moe.dispatch_combine(_t(x), _t(idx), _t(w), part, 3, 8, "silu")
    np.testing.assert_allclose(got.numpy(), _jdispatch(x, idx, w, sl, 3, 8), **FP32)
    unowned = ~np.isin(idx, [3, 4, 5]).any(axis=1)           # tokens no owned expert took
    assert unowned.any() and not got.numpy()[unowned].any()


@pytest.mark.parametrize("E_loc", [1, 2, 4])
def test_dispatch_combine_shards_sum_to_the_whole(E_loc):
    """The partial outputs of E / E_loc shards (each with its own e0) add
    up to the one-device output (a capacity with no drops)."""
    x, idx, w = _dispatch_inputs(5)
    _, p, layer = _pair(seed=5)
    whole = moe.dispatch_combine(_t(x), _t(idx), _t(w), layer.experts.weights(), 0, 24, "silu")
    parts = sum(moe.dispatch_combine(
        _t(x), _t(idx), _t(w), {name: v[e0:e0 + E_loc]
                                for name, v in layer.experts.weights().items()}, e0, 24, "silu")
                for e0 in range(0, 8, E_loc))
    np.testing.assert_allclose(parts.detach().numpy(), whole.detach().numpy(), **FP32)


def test_dispatch_has_no_data_dependent_shape():
    """On ``device="meta"`` nothing can be read back: ``.item()``,
    ``nonzero`` or a boolean-mask index would raise."""
    layer = moe.MoELayer(16, 8, 8, 2, 2, device="meta")
    out, aux = layer(torch.empty((2, 5, 16), device="meta"))
    assert out.shape == (2, 5, 16) and aux.shape == ()


@pytest.mark.parametrize("n_shared", [0, 2])
@pytest.mark.parametrize("T", [1, 12])
def test_moe_layer_matches_jax(n_shared, T):
    """B = 2: T = 1 (a decode step, capacity 8) and T = 12 (24 tokens,
    capacity 8 against 6 expected a expert)."""
    rng = np.random.default_rng(6 + T)
    x = rng.standard_normal((2, T, 16)).astype(np.float32)
    jl, p, layer = _pair(seed=6, n_shared=n_shared)
    jout, jaux = jl.apply(p, jnp.asarray(x))
    assert _routes_apart(np.asarray(jl._route(p, jnp.asarray(x))[0]), 2)
    with torch.no_grad():
        out, aux = layer(_t(x))
        again, _ = layer(_t(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **FP32)
    np.testing.assert_allclose(float(aux), float(jaux), **FP32)
    assert torch.equal(out, again)                           # the same bits twice
    assert [n for n, _ in layer.named_parameters()] == (
        ["router.w", "experts.wi_gate", "experts.wi_up", "experts.wo"]
        + (["shared.wi_gate", "shared.wi_up", "shared.wo"] if n_shared else []))


def test_moe_layer_parameter_shapes_match_jax():
    """deepseek-v2's widths on ``device="meta"`` against ``jax.eval_shape``."""
    kw = dict(d_model=5120, d_ff=1536, n_experts=160, top_k=6, n_shared=2)
    shapes = jax.eval_shape(jmoe.MoELayer(**kw).init, jax.random.PRNGKey(0))
    flat = {".".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    layer = moe.MoELayer(5120, 1536, 160, 6, 2, device="meta")
    assert {n: tuple(t.shape) for n, t in layer.named_parameters()} == flat
    assert dataclasses.fields(jmoe.MoELayer)[-1].name == "aux_loss_coef"
    assert layer.capacity_factor == 1.25 and layer.aux_loss_coef == 0.001
