"""Port parity, the slice as a whole: inline SDIM serving (``mode="inline"``,
the paper's SDIM without the BSE split) and the exact target-attention
baseline (``mode="target_attention"`` with interest kind ``"target"``,
DIN over the whole history) of ``sdim-paper`` (SMOKE), through the JAX
package's ``CTRServer`` and the port's ``CTRServer`` on the CPU, on the
same weights (carried across by ``load_jax_params``) and the same
margin-screened traffic (``test_torch_serving._traffic``).

Tolerances: atol 1e-5 / rtol 1e-4 (the same arithmetic in another order
through a three-layer MLP); port inline vs port decoupled with an fp32 wire
rtol 1e-5 / atol 1e-6, as tests/test_serving.py:28-40.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import sdim_paper as jcfgs
from repro.kernels.target_attn.target_attn import \
    target_attention_flash as jtarget_attention_flash
from repro.models.ctr import CTRModel as JCTRModel
from repro.serve.ctr_server import CTRServer as JCTRServer
from repro_torch.configs import sdim_paper
from repro_torch.models.ctr import CTRModel
from repro_torch.serve.ctr_server import CTRServer
from repro_torch.weights import load_jax_params
from test_torch_serving import WIRE32, _traffic, jax_side  # noqa: F401 (fixture)


def _with_interest(cfg, **kw):
    return dataclasses.replace(cfg, interest=dataclasses.replace(cfg.interest, **kw))


@pytest.fixture(scope="module")
def target_side(jax_side):
    """A kind-"target" SMOKE model on both sides, and traffic whose ids are
    drawn as the sdim model's (target attention hashes nothing, so the
    screening only fixes the draw)."""
    jmodel = JCTRModel(_with_interest(jcfgs.SMOKE, kind="target"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    requests, _ = _traffic(dict(params_np, interest=jax_side[2]["interest"]))
    model = CTRModel(_with_interest(sdim_paper.SMOKE, kind="target"), device="cpu")
    return jmodel, jparams, params_np, model, requests


def _assert_scores_close(ours, ref, **tol):
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, np.asarray(b), **tol)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_inline_server_matches_jax(jax_side, backend):
    """The JAX inline server runs ``engine.serve``: XLA, or the Pallas
    ``bse_serve`` kernel in interpret mode."""
    _, _, params_np = jax_side
    jmodel = JCTRModel(_with_interest(jcfgs.SMOKE, backend=backend))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    requests, _ = _traffic(params_np)
    jserver = JCTRServer.build(jmodel, jparams, "inline")
    server = CTRServer.build(CTRModel(sdim_paper.SMOKE, device="cpu"), params_np, "inline",
                             device="cpu")
    assert server.bse is None
    _assert_scores_close(server.handle_requests(requests), jserver.handle_requests(requests),
                         **WIRE32)
    _assert_scores_close([server.handle_request(*requests[2])],
                         [jserver.handle_request(*requests[2])], **WIRE32)
    assert server.stats.n_requests == jserver.stats.n_requests == len(requests) + 1


def test_target_attention_server_matches_jax(target_side):
    jmodel, jparams, params_np, model, requests = target_side
    jserver = JCTRServer.build(jmodel, jparams, "target_attention")
    server = CTRServer.build(model, params_np, "target_attention", device="cpu")
    _assert_scores_close(server.handle_requests(requests), jserver.handle_requests(requests),
                         **WIRE32)


def test_target_long_branch_matches_pallas_flash(target_side):
    """The long-branch interest of the served traffic (what the port sends
    through ``target_attention_flash``) against JAX's flash kernel in
    interpret mode on the same embeddings."""
    _, _, params_np, model, requests = target_side
    load_jax_params(model, params_np)
    hist = {k: torch.as_tensor(np.concatenate([r[1][k] for r in requests]))
            for k in ("hist_items", "hist_cats", "hist_mask")}
    ci = torch.as_tensor(np.stack([r[2] for r in requests]))
    cc = torch.as_tensor(np.stack([r[3] for r in requests]))
    with torch.no_grad():
        target_e = model._embed_behaviors(ci, cc)
        long_e = model._embed_behaviors(hist["hist_items"], hist["hist_cats"])
        out = model.interest(target_e, long_e, hist["hist_mask"]).numpy()
    C, L = target_e.shape[1], long_e.shape[1]
    ref = jtarget_attention_flash(jnp.asarray(target_e.numpy()), jnp.asarray(long_e.numpy()),
                                  jnp.asarray(hist["hist_mask"].numpy()), block_c=C,
                                  block_l=L // 2, interpret=True)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_inline_equals_decoupled_fp32_wire(jax_side):
    """With a lossless wire, decoupled (bse_encode + sdim_query) and inline
    (bse_serve) scores of one port model agree bit-close."""
    _, _, params_np = jax_side
    requests, _ = _traffic(params_np, seed=2)
    model = CTRModel(sdim_paper.SMOKE, device="cpu")
    dec = CTRServer.build(model, params_np, "decoupled", wire_dtype=torch.float32,
                          device="cpu")
    inl = CTRServer.build(model, None, "inline", device="cpu")
    _assert_scores_close(dec.handle_requests(requests), inl.handle_requests(requests),
                         rtol=1e-5, atol=1e-6)
    assert dec.bse.stats.n_encodes == len(requests)


def test_load_jax_params_target_kind_logits_match(target_side):
    """A kind-"target" model has no ``interest.buffers``: its params load and
    its training-forward logits match JAX's."""
    jmodel, jparams, params_np, model, requests = target_side
    assert params_np["interest"] == {}
    load_jax_params(model, params_np)
    hist = {k: np.concatenate([r[1][k] for r in requests])
            for k in ("hist_items", "hist_cats", "hist_mask")}
    batch = dict(hist, cand_item=np.stack([r[2][1] for r in requests]),
                 cand_cat=np.stack([r[3][1] for r in requests]),
                 ctx=np.stack([r[4][1] for r in requests]))
    with torch.no_grad():
        logits = model.apply({k: torch.as_tensor(v) for k, v in batch.items()}).numpy()
    ref = jmodel.apply(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(logits, np.asarray(ref), **WIRE32)


def test_build_keeps_the_reference_refusals():
    model = CTRModel(sdim_paper.SMOKE, device="cpu")
    for mode in ("inline", "target_attention"):
        with pytest.raises(ValueError, match="fused"):
            CTRServer.build(model, None, mode, fused=True, device="cpu")
    with pytest.raises(ValueError, match="mode"):
        CTRServer.build(model, None, "sharded", device="cpu")
    with pytest.raises(ValueError, match="BSE server"):
        CTRServer(model, None, mode="decoupled")
