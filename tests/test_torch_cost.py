"""``kernels/cost.py``: each engine dispatch's flops and bytes against a
count by hand at a small shape (d = 8, m = 6, tau = 2: G = 3 groups of U =
4 buckets; a hashed row costs 2 m d + G d = 120 operations), and
``chip_smoke.bound`` turning a count into the H100 bound (the larger of
bytes / 3.35 TB/s and operations / 67 TFLOP/s)."""
import importlib.util
import os

import pytest
import torch

from repro_torch.distributed import roofline
from repro_torch.kernels import cost

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TAU = 2
R = torch.zeros((6, 8))                                  # 48 values: 192 bytes
MASK = torch.tensor([[1., 1., 1., 0., 0.], [0., 1., 1., 1., 1.]])   # 7 valid of 10
Q = torch.zeros((2, 3, 8))                               # 48 values: 192 bytes


def test_encode_counts_valid_rows_only():
    for dtype, row_bytes in ((torch.float32, 32), (torch.bfloat16, 16)):
        c = cost.encode(torch.zeros((2, 5, 8), dtype=dtype), MASK, R, tau=TAU)
        # 7 rows hashed; read 7 rows, the mask, R; write 2 tables of 3 x 4 x 8
        assert c == (7 * 120, 7 * row_bytes + 40 + 192 + 2 * 96 * 4)


def test_query_counts_every_candidate_and_table_row():
    c = cost.settle(cost.query(Q, torch.zeros((2, 3, 4, 8), dtype=torch.bfloat16), R, tau=TAU))
    # 6 candidates hashed; every projection is 0, so each candidate selects
    # bucket 2^tau - 1 of each group: 2 x 3 of the 24 table rows read (bf16)
    # and normalized and summed (3 d each); q read and the output written, R
    assert c == (6 * 120 + 6 * 3 * 8, 6 * 8 * 2 + 2 * 192 + 192)


def test_query_counts_only_the_rows_its_candidates_select():
    """R's rows pick q's first six coordinates, so a candidate's signs there
    set its bucket in each of the 3 groups. User 0's three candidates are
    one vector (3 rows); user 1's are all +, all - and (+, -) per group,
    three buckets in every group (9 rows)."""
    Rp = torch.eye(6, 8)
    signs = torch.tensor([[1., 1., 1., 1., 1., 1.]] * 3
                         + [[1., 1., 1., 1., 1., 1.], [-1.] * 6, [1., -1.] * 3])
    q = torch.cat([signs, torch.ones(6, 2)], 1).reshape(2, 3, 8)
    c = cost.settle(cost.query(q, torch.zeros((2, 3, 4, 8)), Rp, tau=TAU))
    assert c == (6 * 120 + 12 * 3 * 8, 12 * 8 * 4 + 2 * 192 + 192)


def test_serve_counts_rows_candidates_and_the_table_in_shared_memory():
    c = cost.serve(Q, torch.zeros((2, 5, 8)), MASK, R, tau=TAU)
    assert c == ((7 + 6) * 120 + 24 * 3 * 8, 7 * 32 + 40 + 2 * 192 + 192)


def test_serve_fused_reads_present_users_rows_and_scales():
    store = torch.zeros((4, 3, 4, 8), dtype=torch.int8)
    scales = torch.zeros((4, 3, 4))
    slots = torch.tensor([2, 0], dtype=torch.int32)
    c = cost.serve_fused(store, slots, Q, R, tau=TAU, scales=scales,
                         present=torch.tensor([1., 0.]))
    # one present user: its 96 int8 values + 12 scales, its 3 x 8 output;
    # q of both, R, slots and present flags of both
    assert c == (3 * 120 + 12 * 3 * 8, (96 + 48 + 96) + 192 + 192 + 2 * 8)
    everyone = cost.serve_fused(store.float(), slots, Q, R, tau=TAU)
    assert everyone == (2 * (3 * 120 + 12 * 3 * 8), 2 * (96 * 4 + 96) + 192 + 192 + 2 * 8)


def test_update_counts_valid_events_and_touched_slots():
    store = torch.zeros((4, 3, 4, 8))
    slots = torch.tensor([1, 1, 2], dtype=torch.int32)
    mask = torch.tensor([[1., 1.], [0., 1.], [0., 0.]])  # slot 2's row has no event
    c = cost.update(store, slots, torch.zeros((3, 2, 8)), mask, R, tau=TAU)
    # 3 events hashed; slot 1 read and written once; 3 event rows, the
    # mask, 3 slots, R
    assert c == (3 * 120, 2 * 96 * 4 + 3 * 32 + 24 + 12 + 192)


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT,
                                                                           "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("flops, nbytes, by", [(67e9, 1e3, "operations"),
                                               (1.0, 3.35e9, "bytes")])
def test_chip_smoke_bound_reads_a_count(chip_smoke, flops, nbytes, by):
    """1 ms of operations or of bytes on the H100, read through
    ``chip_smoke.bound`` and ``roofline.analyze`` alike."""
    ms, got_by = chip_smoke.bound(cost.Cost(flops, nbytes))
    assert (ms, got_by) == (pytest.approx(1.0), by)
    assert 1e3 * roofline.analyze("x", flops, nbytes).roofline_time == pytest.approx(ms)
    c = cost.encode(torch.zeros((2, 5, 8)), MASK, R, tau=TAU)
    assert chip_smoke.bound(c)[0] == pytest.approx(
        1e3 * max(c.bytes / 3.35e12, c.flops / 67e12))
