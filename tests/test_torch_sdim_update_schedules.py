"""CPU rehearsal of sdim_update' schedules (the tau <= 4 fold's owners and
group slices): numpy emulations of how the kernels split and merge their
work, held against the JAX package on seeded, margin-screened inputs (the
emulations and the whole list: tests/torch_schedules.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sdim_update.ref import sdim_update_ref as jsdim_update_ref
from repro.kernels.sdim_update.sdim_update import sdim_update as jsdim_update
from repro_torch.kernels.sdim_update.sdim_update import (sdim_update_ref, update_cells,
                                                         update_splits)
from torch_schedules import FP32, _signatures, _update_inputs, sdim_update_schedule


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", ["dups", "two-slots"])
@pytest.mark.parametrize("shape", [
    (6, 5, 32, 12, 2, 4),        # G = 6 over S = 4: slices 1, 2, 1, 2; E = 5
    (6, 16, 128, 48, 3, 4),      # the main path's width: 4 groups a CTA, E = 16
    (5, 16, 128, 36, 3, 8),      # G = 12 over S = 8: slices of 1 or 2
    (4, 80, 64, 24, 4, 2),       # U = 16, E = 80: two event batches a row
    (6, 16, 36, 48, 3, 3),       # dien FULL: d = 36, the fewest slices (6 groups a CTA)
    (6, 5, 36, 10, 2, 4),        # d = 36, E = 5: bf16 rows on 8-byte boundaries
    (6, 5, 4, 12, 2, 3),         # d = 4, E = 5: bf16 event rows of 8 bytes
    (6, 16, 20, 24, 3, 8),       # d = 20: a group a CTA
    (5, 40, 44, 16, 4, 2),       # d = 44, U = 16, E = 40: two event batches a row
], ids=["G6-S4-E5", "full-width", "G12-S8", "U16-E80", "dien-d36", "G5-E5-d36", "G6-E5-d4",
        "G8-d20", "U16-E40-d44"])
def test_sdim_update_schedule_matches_jax(shape, case, dtype):
    """Against JAX's segment-sum oracle and the Pallas kernel in interpret
    mode: every element is written at most once, a zero-mask row and an
    all-masked duplicate write nothing, and untouched cells (signed zeros
    included) keep their exact bits."""
    B, E, d, m, tau, S = shape
    rng = np.random.default_rng(15)
    store, slots, events, mask, R = _update_inputs(rng, B, E, d, m, tau, case)
    jev = jnp.asarray(events, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    ev = np.asarray(jev).astype(np.float32)       # the event values, exactly
    out, writes = sdim_update_schedule(store, slots, np.asarray(jev), mask, R, tau, S)
    args = (jnp.asarray(store), jnp.asarray(slots), jev, jnp.asarray(mask), jnp.asarray(R), tau)
    np.testing.assert_allclose(out, np.asarray(jsdim_update_ref(*args)), **FP32)
    np.testing.assert_allclose(out, np.asarray(jsdim_update(*args, interpret=True)), **FP32)
    assert writes.max() <= 1
    untouched = writes == 0
    assert (out.view(np.uint32)[untouched] == store.view(np.uint32)[untouched]).all()
    if case == "dups":
        assert not writes[0].any()                # slot 0: only the zero-mask row
    reached = np.zeros_like(writes, bool)         # cells some weighted event reached
    G, U = m // tau, 1 << tau
    sig = _signatures(ev.reshape(-1, d), R.reshape(G, tau, d), tau).reshape(B, E, G)
    for b, e in zip(*np.nonzero(mask)):
        reached[slots[b], np.arange(G), sig[b, e]] = True
    np.testing.assert_array_equal(writes == 1, reached)


def test_sdim_update_schedule_no_events_writes_nothing():
    """E = 0 (against the plain version alone: the Pallas kernel takes no
    empty block): the store comes back bit for bit."""
    rng = np.random.default_rng(16)
    store, slots, events, mask, R = _update_inputs(rng, 6, 0, 32, 12, 2, "dups")
    out, writes = sdim_update_schedule(store, slots, events, mask, R, 2, 4)
    plain = sdim_update_ref(torch.from_numpy(store.copy()), torch.from_numpy(slots),
                            torch.from_numpy(events), torch.from_numpy(mask),
                            torch.from_numpy(R), 2)
    np.testing.assert_allclose(out, plain.numpy(), **FP32)
    assert not writes.any()
    np.testing.assert_array_equal(out.view(np.uint32), store.view(np.uint32))


@pytest.mark.parametrize("B, G, U, d, want", [
    (32, 16, 8, 128, 8),         # the 32-user event fold: 256 CTAs, two groups each
    (16, 16, 8, 128, 16),        # a 16-user fold: a group a CTA
    (1, 16, 8, 128, 16),         # one user: never more slices than groups
    (1024, 16, 8, 128, 8),       # a large batch: the fewest slices, 2 groups each
    (1024, 12, 16, 128, 12),     # U = 16: a group a CTA at most
    (64, 6, 4, 32, 4),           # as many as one wave allows
    (16, 6, 4, 32, 6),           # never more than G
    (0, 16, 8, 128, 16),         # no batch row
    (32, 16, 8, 36, 8),          # d = 36: 28 cells a pass of the block, 56 a CTA
    (1024, 16, 8, 36, 3),        # d = 36, a large batch: the fewest slices, 6 groups each
])
def test_update_splits_fill_one_wave(B, G, U, d, want):
    S = update_splits(B, G, U, d, n_sm=132)
    assert S == want
    assert 1 <= S <= G and -(-G // S) * U <= update_cells(d)
    assert B * S <= 2 * 132 or S == -(-G // (update_cells(d) // U))
