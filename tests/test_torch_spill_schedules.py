"""CPU rehearsal of the SDIM kernels' paths past their shared-memory
lists and copies: numpy emulations of the chunked orders, with the limit
as a parameter so that small inputs cross it, held against the JAX
package on seeded, margin-screened inputs and against the same emulation
with no limit crossed.

- sdim_update's large-tau fold (``sdim_update_large_tau.cu``, CHUNKED):
  a row of more than ``max_e`` events is hashed and sorted in chunks; a
  cell's partial row sum is carried from chunk to chunk in a scratch (a
  mark a cell says it holds one) and added to the stored cell once, after
  the row's last chunk, rows in b order;
- bse_encode's spans: the tau <= 4 kernel (``bse_encode.cu``) lists each
  span's live 8-row batches and deals them to its warps in turn, the
  warps' sums carried from span to span; the large-tau forward
  (``bse_encode_large_tau.cu``, SPANS) lists each span's rows by bucket and
  starts each cell's chain from the sum the last span stored;
- sdim_query_backward's large-tau chunks (``sdim_query_large_tau.cu``,
  CHUNKS): each chunk's candidates are listed by bucket and add dout / G in
  c order to the partial g kept in the row of dT; then (g - t^ (t^ . g)) / n
  for every row some chunk selected, +0 for the others;
- bse_encode_backward past MAX_BWD_SMEM: the same gather in g order from
  +0, dT (and R) read from device memory, so the same emulation.

Which shapes take the new paths, and which keep today's, is held on the
wrappers' pure-Python choices. Tolerance: fp32 atol 1e-5 / rtol 1e-5 (the
same sums in another order), as tests/test_kernels.py:46-58; cells no
weighted event reaches compare bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.sdim_bucket.ref import bse_encode_ref as jbse_encode_ref
from repro.kernels.sdim_update.ref import sdim_update_ref as jsdim_update_ref
from repro_torch.kernels.screen import screened_normal
from repro_torch.kernels.sdim_bucket.sdim_bucket import (MAX_BWD_SMEM, MAX_L, LT_BWD_DEVICE,
                                                         backward_layout, encode_large_tau_splits,
                                                         encode_backward_large_tau_split,
                                                         encode_spans)
from repro_torch.kernels.sdim_query.sdim_query import (MAX_BWD_CANDS,
                                                       query_backward_large_tau_path,
                                                       query_backward_large_tau_splits)
from repro_torch.kernels.sdim_update.sdim_update import (UPDATE_LT_MAX_E,
                                                         update_large_tau_path)
from torch_schedules import (FP32, _jax_encode_vjp, _jax_sdim_backward, _link_lists, _mask,
                             _signatures, _walk, bse_encode_backward_schedule,
                             bse_encode_schedule, bwd_lt_ctas, encode_backward_large_tau_schedule,
                             encode_large_tau_schedule, query_backward_large_tau_schedule)


def _draw(seed, B, L, d, m):
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((m, d)).astype(np.float32)
    return rng, R, screened_normal(rng, (B, L, d), R)


# ---------------------------------------------------------------------------
# sdim_update's large-tau fold in chunks
# ---------------------------------------------------------------------------
def update_chunked_schedule(store, slots, events, mask, R, tau, max_e):
    """sdim_update_large_tau.cu in numpy fp32: the first batch row of each
    slot owns it and folds the slot's rows in b order. A row of at most
    ``max_e`` events is one sub-window: each cell its weighted events reach
    gets the row's sum, from +0 in e order, added once. A longer row is
    taken in chunks of ``max_e`` events: each chunk's events are sorted by
    bucket (stable: e order within a cell), each reached cell's sum starts
    from the scratch where its mark is set (else +0) and goes back to the
    scratch; after the row's last chunk every marked cell gets cell + sum
    and the marks clear. Returns the store and the write counts of its
    cells."""
    out = store.copy()
    writes = np.zeros(store.shape[:3], np.int64)
    B, E, d = events.shape
    G, U = R.shape[0] // tau, 1 << tau
    sig = _signatures(events.reshape(B * E, d).astype(np.float32), R.reshape(G, tau, d),
                      tau).reshape(B, E, G)
    for b in range(B):
        slot = slots[b]
        if slot in slots[:b]:
            continue                                  # an earlier row owns the slot
        for r in [r for r in range(b, B) if slots[r] == slot]:
            x = events[r].astype(np.float32)
            if E <= max_e:                            # one sub-window
                for g in range(G):
                    for u in range(U):
                        hit = [e for e in range(E) if mask[r, e] != 0 and sig[r, e, g] == u]
                        if hit:
                            delta = np.zeros(d, np.float32)
                            for e in hit:
                                delta = delta + mask[r, e] * x[e]
                            out[slot, g, u] = out[slot, g, u] + delta
                            writes[slot, g, u] += 1
                continue
            scratch = np.full((G, U, d), np.nan, np.float32)
            marks = np.zeros((G, U), bool)
            for e0 in range(0, E, max_e):             # the chunks
                chunk = [e for e in range(e0, min(E, e0 + max_e)) if mask[r, e] != 0]
                for g in range(G):
                    order = sorted(chunk, key=lambda e: sig[r, e, g])   # stable: e order
                    for u in sorted({sig[r, e, g] for e in chunk}):
                        delta = scratch[g, u] if marks[g, u] else np.zeros(d, np.float32)
                        for e in order:
                            if sig[r, e, g] == u:
                                delta = delta + mask[r, e] * x[e]
                        scratch[g, u] = delta
                        marks[g, u] = True
            for g, u in zip(*np.nonzero(marks)):     # after the row's last chunk
                out[slot, g, u] = out[slot, g, u] + scratch[g, u]
                writes[slot, g, u] += 1
    return out, writes


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("E, max_e", [(20, 8), (17, 16), (8, 8)],
                         ids=["E20-chunks-of-8", "E17-chunks-of-16", "E8-one-sub-window"])
def test_sdim_update_chunks_match_jax(E, max_e, dtype):
    """Six batch rows on three slots (two rows on one slot, a zero-mask
    row) at tau 5, d = 16: the chunked fold against the JAX package's
    sdim_update_ref, bit for bit against the same fold in one sub-window,
    the cells no weighted event reached keeping their bits (-0.0
    included), every reached cell written once a row."""
    B, d, m, tau = 6, 16, 10, 5
    rng, R, events = _draw(40 + E, B, E, d, m)
    if dtype == "bf16":
        events = np.asarray(jnp.asarray(events, jnp.bfloat16).astype(jnp.float32))
    mask = (rng.random((B, E)) > 0.2).astype(np.float32)
    mask[2] = 0.0                                     # a zero-mask row
    slots = np.array([1, 3, 0, 1, 2, 3], np.int32)
    store = rng.standard_normal((4, m // tau, 1 << tau, d)).astype(np.float32)
    store[:, :, ::3, :4] = -0.0
    out, writes = update_chunked_schedule(store, slots, events, mask, R, tau, max_e)
    one, _ = update_chunked_schedule(store, slots, events, mask, R, tau, E)
    assert np.array_equal(out.view(np.int32), one.view(np.int32))
    want = np.asarray(jsdim_update_ref(jnp.asarray(store), jnp.asarray(slots),
                                       jnp.asarray(events), jnp.asarray(mask), jnp.asarray(R), tau))
    np.testing.assert_allclose(out, want, **FP32)
    untouched = writes == 0
    assert np.array_equal(out[untouched].view(np.int32), store[untouched].view(np.int32))
    assert writes[0].sum() == 0                       # only the zero-mask row aims at slot 0
    assert writes.max() <= 2 and (writes[1] > 0).any()


# ---------------------------------------------------------------------------
# bse_encode's spans
# ---------------------------------------------------------------------------
def encode_spans_schedule(seq, mask, R, tau, S, span, batch=8, warps=16):
    """bse_encode.cu (tau <= 4) in numpy fp32 with spans of ``span`` rows
    (a multiple of ``batch``): for each span in turn, its batches with a
    nonzero weight are listed and entry i goes to warp i % warps, which adds
    each row of its batches to its cell in row order, its sums carried from
    span to span; the warps' tables are summed in warp order. S CTAs a user
    over the groups, as ``bse_encode_schedule``."""
    assert span % batch == 0
    B, L, d = seq.shape
    G, U = R.shape[0] // tau, 1 << tau
    Rg = R.reshape(G, tau, d)
    out = np.full((B, G, U, d), np.nan, np.float32)
    for b in range(B):
        for rank in range(S):
            g0, g1 = rank * G // S, (rank + 1) * G // S
            parts = np.zeros((warps, g1 - g0, U, d), np.float32)
            for s0 in range(0, L, span):
                hi = min(L, s0 + span)
                live = [t for t in range(s0 // batch, -(-hi // batch))
                        if (mask[b, t * batch:(t + 1) * batch] != 0).any()]
                for v in range(warps):
                    for t in live[v::warps]:
                        rows = np.arange(t * batch, min(hi, (t + 1) * batch))
                        rows = rows[mask[b, rows] != 0]
                        sig = _signatures(seq[b, rows], Rg[g0:g1], tau)
                        for i, row in enumerate(rows):
                            for gl in range(g1 - g0):
                                parts[v, gl, sig[i, gl]] = (parts[v, gl, sig[i, gl]]
                                                            + mask[b, row] * seq[b, row])
            total = np.zeros((g1 - g0, U, d), np.float32)
            for v in range(warps):                    # warp order
                total = total + parts[v]
            out[b, g0:g1] = total
    return out


@pytest.mark.parametrize("L, span", [(50, 16), (130, 32), (50, 64)],
                         ids=["L50-spans-of-16", "L130-spans-of-32", "L50-one-span"])
def test_bse_encode_spans_match_jax(L, span):
    """tau <= 4 (tau 2, G = 6 over 2 CTAs; a wholly masked batch and a fully
    masked user): the spanned schedule against the JAX package's
    bse_encode_ref; with one span it is bse_encode_schedule bit for bit."""
    B, d, m, tau, S = 3, 16, 12, 2, 2
    rng, R, seq = _draw(50 + L, B, L, d, m)
    mask = _mask(rng, B, L, "random")
    mask[0, 16:24] = 0.0                              # a wholly masked batch
    out = encode_spans_schedule(seq, mask, R, tau, S, span)
    want = np.asarray(jbse_encode_ref(jnp.asarray(seq), jnp.asarray(mask), jnp.asarray(R), tau))
    np.testing.assert_allclose(out, want, **FP32)
    assert not out[-1].any()
    if span >= L:
        assert np.array_equal(out, bse_encode_schedule(seq, mask, R, tau, S)[0])


def encode_large_tau_spans_schedule(seq, mask, R, tau, span):
    """bse_encode_large_tau.cu's SPANS forward in numpy fp32: for each span
    of ``span`` rows in turn, each group's rows of nonzero weight are linked
    into one list a bucket (``_link_lists``, span-relative indices below
    ``span``) and each cell adds its list's rows in order to the sum the
    last span stored (+0 in the first), then stores it. Returns the table."""
    B, L, d = seq.shape
    G, U = R.shape[0] // tau, 1 << tau
    Rg = R.reshape(G, tau, d)
    out = np.zeros((B, G, U, d), np.float32)
    for b in range(B):
        for s0 in range(0, L, span):
            x, w = seq[b, s0:s0 + span].astype(np.float32), mask[b, s0:s0 + span]
            for g in range(G):
                keys = np.where(w != 0, _signatures(x, Rg[g:g + 1], tau)[:, 0], -1)
                head, link = _link_lists(keys, U)
                for u in range(U):
                    rows = _walk(head, link, u)
                    assert all(r < span for r in rows)
                    acc = out[b, g, u]
                    for r in rows:
                        acc = acc + w[r] * x[r]
                    out[b, g, u] = acc
    return out


@pytest.mark.parametrize("tau, m", [(5, 10), (7, 14)])
@pytest.mark.parametrize("L, span", [(50, 16), (70, 32)])
def test_bse_encode_large_tau_spans_match_jax(L, span, tau, m):
    """tau 5..10: the spanned forward is the unspanned schedule
    (encode_large_tau_schedule) bit for bit (each cell's chain goes on over
    the next span's rows in l order), and matches the JAX package."""
    B, d = 2, 16
    rng, R, seq = _draw(60 + L + tau, B, L, d, m)
    mask = _mask(rng, B, L, "front")
    out = encode_large_tau_spans_schedule(seq, mask, R, tau, span)
    whole = encode_large_tau_schedule(seq, mask, R, tau)[0]
    assert np.array_equal(out.view(np.int32), whole.view(np.int32))
    want = np.asarray(jbse_encode_ref(jnp.asarray(seq), jnp.asarray(mask), jnp.asarray(R), tau))
    np.testing.assert_allclose(out, want, **FP32)


# ---------------------------------------------------------------------------
# sdim_query_backward's large-tau chunks
# ---------------------------------------------------------------------------
def query_backward_chunked_schedule(dout, q, table, R, tau, chunk):
    """sdim_query_large_tau.cu's CHUNKS backward in numpy fp32: for each
    chunk of ``chunk`` candidates in turn, each group's candidates are
    linked into one list a bucket; each row a list selects adds dout / G of
    its list's candidates in c order to its partial g in the row of dT
    (from +0 where no earlier chunk selected it) and is marked; then every
    marked row reads its table row once and writes (g - t^ (t^ . g)) / n,
    every other row +0. Returns dT and the table rows' read counts."""
    B, C, d = q.shape
    G, U = R.shape[0] // tau, 1 << tau
    fG = np.float32(G)
    sig = _signatures(q.reshape(B * C, d), R.reshape(G, tau, d), tau).reshape(B, C, G)
    dT = np.full((B, G, U, d), np.nan, np.float32)
    reads = np.zeros((B, G, U), np.int64)
    for b in range(B):
        marks = np.zeros((G, U), bool)
        for c0 in range(0, C, chunk):
            for g in range(G):
                head, link = _link_lists(sig[b, c0:c0 + chunk, g], U)
                for u in range(U):
                    cands = _walk(head, link, u)
                    if not cands:
                        continue
                    gv = dT[b, g, u] if marks[g, u] else np.zeros(d, np.float32)
                    for c in cands:
                        gv = gv + dout[b, c0 + c] / fG
                    dT[b, g, u] = gv
                    marks[g, u] = True
        for g in range(G):
            for u in range(U):
                if not marks[g, u]:
                    dT[b, g, u] = 0.0
                    continue
                t, gv = table[b, g, u], dT[b, g, u]
                reads[b, g, u] += 1
                n = np.sqrt(np.sum(t * t) + np.float32(1e-12))
                th = t / n
                dT[b, g, u] = (gv - th * np.sum(th * gv)) / n
    return dT, reads


@pytest.mark.parametrize("tau, m", [(5, 10), (6, 12)])
@pytest.mark.parametrize("C, chunk", [(40, 16), (33, 32), (20, 32)],
                         ids=["C40-chunks-of-16", "C33-chunks-of-32", "C20-one-chunk"])
def test_sdim_query_backward_chunks_match_jax(C, chunk, tau, m):
    """The chunked backward is the one-list schedule
    (query_backward_large_tau_schedule) bit for bit and matches jax.grad
    of the JAX package's XLA formulation; half the candidates are the
    user's own behaviors, so rows are selected by candidates of several
    chunks; each selected row's table row is read once."""
    B, L, d = 1, 60, 16
    rng, R, seq = _draw(70 + C + tau, B, L, d, m)
    mask = _mask(rng, B, L, "random")
    q = screened_normal(rng, (B, C, d), R)
    q[0, :C // 2] = seq[0, rng.choice(np.flatnonzero(mask[0]), C // 2)]
    dout = rng.standard_normal((B, C, d)).astype(np.float32)
    table, jdT, _ = _jax_sdim_backward(dout, q, seq, mask, R, tau)
    dT, reads = query_backward_chunked_schedule(dout, q, table, R, tau, chunk)
    one = query_backward_large_tau_schedule(dout, q, table, R, tau)[0]
    assert np.array_equal(dT.view(np.int32), one.view(np.int32))
    np.testing.assert_allclose(dT, jdT, **FP32)
    assert reads.max() == 1
    if C >= 2 * chunk:                                # rows that two chunks select
        sig = _signatures(q[0], R.reshape(m // tau, tau, d), tau)
        assert any(set(sig[:chunk, g]) & set(sig[chunk:, g]) for g in range(m // tau))


# ---------------------------------------------------------------------------
# bse_encode_backward past MAX_BWD_SMEM
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m, tau, d, layout", [(96, 4, 128, "spill"), (192, 3, 128, "spill"),
                                               (500, 4, 128, "spill_r")])
def test_bse_encode_backward_spill_matches_jax(m, tau, d, layout):
    """tau <= 4 where the user's dT and R exceed MAX_BWD_SMEM: the gather
    reads dT (and R) from device memory in the same order, each row's G rows
    of dT in g order from +0, times its mask (bse_encode_backward_schedule)
    against jax.vjp of the JAX package's XLA formulation."""
    B, L = 2, 24
    G, U = m // tau, 1 << tau
    assert backward_layout(G, U, d, m) == layout
    rng, R, seq = _draw(80 + m, B, L, d, m)
    mask = _mask(rng, B, L, "random")
    dT = rng.standard_normal((B, G, U, d)).astype(np.float32)
    out, writes = bse_encode_backward_schedule(dT, seq, mask, R, tau, S=2)
    assert (writes == 1).all()
    np.testing.assert_allclose(out, _jax_encode_vjp(dT, seq, mask, R, tau), **FP32)


def test_large_tau_backward_device_layout_matches_jax():
    """tau 5, m = 500, d = 128 (R alone is 256,000 B): the split on the
    model card picks LT_BWD_DEVICE (R from device memory, four lanes a
    row); the gather in g order against jax.vjp."""
    B, L, d, m, tau = 1, 40, 128, 500, 5
    G, U = m // tau, 1 << tau
    layout, S = encode_backward_large_tau_split(B, L, d, 132, bwd_lt_ctas(G, U, L, d, tau))
    assert layout is LT_BWD_DEVICE and S >= 1
    rng, R, seq = _draw(90, B, L, d, m)
    mask = _mask(rng, B, L, "random")
    dT = rng.standard_normal((B, G, U, d)).astype(np.float32)
    out, writes, hashes, _, _ = encode_backward_large_tau_schedule(dT, seq, mask, R, tau)
    assert (writes == 1).all() and (hashes == (mask != 0)[..., None]).all()
    np.testing.assert_allclose(out, _jax_encode_vjp(dT, seq, mask, R, tau), **FP32)


# ---------------------------------------------------------------------------
# Which shapes take the new paths
# ---------------------------------------------------------------------------
def test_update_path_choice():
    """Up to UPDATE_LT_MAX_E events a row the fold sorts at once (no
    scratch), as before; one more takes the chunks."""
    assert UPDATE_LT_MAX_E == 8192
    assert [update_large_tau_path(E) for E in (1, 16, 300, 8192)] == ["sorted"] * 4
    assert [update_large_tau_path(E) for E in (8193, 20000)] == ["chunked"] * 2


@pytest.mark.parametrize("L, spans", [(1, 1), (1024, 1), (MAX_L, 1), (MAX_L + 1, 2),
                                      (2 * MAX_L, 2), (2 * MAX_L + 1, 3)])
def test_encode_span_choice(L, spans):
    """A user of up to MAX_L behaviors is one span (today's path, its
    splits as before); a longer one spans, each span's lists sized as
    MAX_L's."""
    assert encode_spans(L) == spans
    for B, G, U, d, tau in ((16, 4, 1024, 128, 10), (128, 9, 32, 32, 5)):
        split = encode_large_tau_splits(B, G, U, L, d, tau, 132)
        assert split == encode_large_tau_splits(B, G, U, min(L, MAX_L), d, tau, 132)


@pytest.mark.parametrize("G, U, d, m, want", [
    (16, 8, 128, 48, "shared"),      # sdim-paper FULL's training step
    (16, 8, 32, 48, "shared"),       # the Table 2/3 protocol's d = 32
    (24, 16, 128, 96, "spill"),      # m = 96 at tau 4: 245,760 B of dT and R
    (64, 8, 128, 192, "spill"),      # m = 192 at tau 3: 360,448 B
    (125, 16, 128, 500, "spill_r"),  # R alone is 256,000 B
])
def test_encode_backward_layout_choice(G, U, d, m, want):
    """The tau <= 4 backward keeps its shared copy where dT and R fit
    MAX_BWD_SMEM; past it dT, and R where it does not fit alone, come from
    device memory."""
    assert backward_layout(G, U, d, m) == want
    assert (want == "shared") == (4 * (G * U * d + m * d) <= MAX_BWD_SMEM)


@pytest.mark.parametrize("B, L, G, U, d, tau, want", [
    (128, 256, 9, 32, 32, 5, True),         # Table 4's tau 5: dT staged, as before
    (128, 256, 4, 1024, 32, 10, False),     # Table 4's tau 10: R staged, as before
    (4, 1024, 100, 32, 128, 5, LT_BWD_DEVICE),   # m = 500: R alone past a CTA
])
def test_large_tau_backward_layout_choice(B, L, G, U, d, tau, want):
    """The large-tau backward's layouts on the model card: today's two where
    they fit, the device layout where R and a round's ids do not."""
    layout, S = encode_backward_large_tau_split(B, L, d, 132, bwd_lt_ctas(G, U, L, d, tau))
    assert layout is want or (layout == want and isinstance(want, bool))
    assert S >= 1


@pytest.mark.parametrize("C, path", [(1, "lists"), (2000, "lists"), (MAX_BWD_CANDS, "lists"),
                                     (MAX_BWD_CANDS + 1, "chunked"), (40000, "chunked")])
def test_query_backward_chunk_choice(C, path):
    """Up to MAX_BWD_CANDS candidates a user the large-tau backward lists
    them at once, as before; more go in chunks of MAX_BWD_CANDS, whose
    lists size the split."""
    assert query_backward_large_tau_path(C) == path
    for B, G, U, d, tau in ((128, 4, 1024, 32, 10), (2, 8, 32, 128, 5)):
        assert (query_backward_large_tau_splits(B, G, U, C, d, tau, 132)
                == query_backward_large_tau_splits(B, G, U, min(C, MAX_BWD_CANDS), d, tau, 132))
