"""Port parity, the paper's benchmarks (``repro_torch.bench``) against
``benchmarks/`` on the CPU, at small sizes:

* Fig. 2: every ``fig2/*`` row's ``derived`` equals the reference's (the
  ``fig2/curves_csv`` row names the file each package writes) and the
  CSVs are equal byte for byte, each run in its own working directory.
* Table 4: the ``kernel_entropy`` of every τ equals the reference's (the
  training both modules call is stubbed: it does not enter the entropy);
  the long branch of τ 5 and 10 (the SDIM wrappers' large-τ range) against
  the reference's Pallas kernels and ``jax.grad``.
* Fig. 5: ``estimator_error_of`` on the reference's R (m ∈ {12, 48},
  d = 32) and seq/q margin-screened against it (L = 64) agrees with the
  reference's cosine distance within 1e-5.
* Table 1: the row names of a quick run equal the reference's.
* Table 5: the transmission bytes and the fp32/int8 ``table_bytes`` and
  ``bytes_ratio`` equal the reference's at the same config; the pressure
  section's hit rate, promote/demote counts and moved bytes under the same
  numpy-seeded Zipf traffic equal the reference's at both of its sizes;
  one ``run`` at small sizes gives an AUC gap within the reference's
  1e-3, fused equal to two-dispatch within 1e-5, the SLO and ingest
  balances, and a dict that ``tools/bench_check.check`` accepts.
* ``bench.common.time_fn``: ``warmup`` untimed calls, then the median of
  ``iters`` timed ones; ``bench.table5_profile`` runs small on the CPU.
* ``run.py``: ``--only fig2 --device cpu`` prints the CSV header and one
  line per row; ``roofline_rows`` reads the port's dry-run JSONs.
"""
import importlib.util
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import fig2_attention_patterns as jfig2
from benchmarks import table1_complexity as jtable1
from benchmarks import table4_tau as jtable4
from benchmarks import table5_serving as jtable5
from repro.core import sdim as jsdim
from repro.core import simhash as jsimhash
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.engine import SDIMEngine as JSDIMEngine
from repro.core.interest import InterestConfig as JInterestConfig
from repro.data.synthetic import SyntheticCTRConfig as JSyntheticCTRConfig
from repro.kernels.sdim_bucket.sdim_bucket import bse_encode as jbse_encode
from repro.kernels.sdim_query.sdim_query import sdim_query as jsdim_query
from repro.data.synthetic import generate_batch as jgenerate_batch
from repro.models.ctr import CTRConfig as JCTRConfig
from repro.models.ctr import CTRModel as JCTRModel
from repro.serve.bse_server import BSEServer as JBSEServer
from repro.serve.ctr_server import CTRServer as JCTRServer
from repro_torch.bench import (common, fig2_attention_patterns, fig5_m_sweep, run,
                               table1_complexity, table4_tau, table5_profile, table5_serving)
from repro_torch.kernels.screen import screened_normal
from repro_torch.kernels.sdim_bucket.sdim_bucket import bse_encode
from repro_torch.kernels.sdim_query.sdim_query import sdim_query
from repro_torch.launch import dryrun

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FP32 = dict(atol=1e-5, rtol=1e-5)
# the sizes of one small run of every Table 5 section on the CPU
SMALL = {
    "ablation": dict(T=64, B=16, n_req=2),
    "throughput": dict(n_users=16, chunk=8),
    "fused": dict(n_users=16, reps=1),
    "auc": dict(steps=20, n_eval=256),
    "sharded": dict(n_users=32, chunk=16),
    "ingest": dict(n_bursts=8, gap_s=0.002, linger_s=0.01),
    "pressure": dict(hot=8, L=16, n_bursts=4),
    "slo": dict(n_bursts=12, gap_s=0.002),
    "trace": dict(n_bursts=6),
    "profile": dict(n_bursts=4),
}


def _bench_check():
    spec = importlib.util.spec_from_file_location(
        "bench_check", os.path.join(ROOT, "tools", "bench_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# Fig. 2, Table 4, Fig. 5, Table 1
# ---------------------------------------------------------------------------
def test_fig2_rows_and_csv_match_the_reference(tmp_path, monkeypatch):
    rows = {}
    for tag, mod in (("jax", jfig2), ("port", fig2_attention_patterns)):
        (tmp_path / tag).mkdir()
        monkeypatch.chdir(tmp_path / tag)
        rows[tag] = mod.run()
    assert [r["name"] for r in rows["port"]] == [r["name"] for r in rows["jax"]]
    for mine, theirs in zip(rows["port"], rows["jax"]):
        if mine["name"] == "fig2/curves_csv":
            assert (theirs["derived"], mine["derived"]) == (
                "results/fig2_curves.csv", "results/torch/fig2_curves.csv")
        else:
            assert mine["derived"] == theirs["derived"], mine["name"]
    assert ((tmp_path / "port" / "results" / "torch" / "fig2_curves.csv").read_bytes()
            == (tmp_path / "jax" / "results" / "fig2_curves.csv").read_bytes())


def test_table4_kernel_entropy_matches_the_reference(monkeypatch):
    calls = []

    def stub(kind, **kw):
        calls.append(kw)
        return {"auc": 0.5 + 0.01 * kw["tau"], "us_per_step": 1.0}

    monkeypatch.setattr(jtable4, "train_and_eval", stub)
    theirs = jtable4.run(quick=True, smoke=True)
    calls.clear()
    monkeypatch.setattr(table4_tau, "train_and_eval", stub)
    mine = table4_tau.run(quick=True, smoke=True, device="cpu")
    assert [r["name"] for r in mine] == [r["name"] for r in theirs]
    entropy = lambda rows: [re.search(r"kernel_entropy=([0-9.]+)", r["derived"]).group(1)
                            for r in rows if "kernel_entropy" in r["derived"]]
    assert entropy(mine) == entropy(theirs) and len(entropy(mine)) == len(table4_tau.TAUS)
    assert mine[-1]["derived"] == theirs[-1]["derived"]
    assert [(c["tau"], c["m"]) for c in calls] == [(1, 48), (2, 48), (3, 48), (5, 45), (10, 40)]


def test_table5_profile_runs_on_the_cpu(tmp_path):
    """``bench.table5_profile`` at a small size on the CPU: every
    deployment timed, its device columns "not measured" (no card), its
    host profile counted, and the JSON written where asked."""
    out = table5_profile.main(["--device", "cpu", "--requests", "1", "--T", "32", "--B", "8",
                               "--out", str(tmp_path / "p.json")])
    assert json.loads((tmp_path / "p.json").read_text()) == out
    for mode, _ in table5_profile.DEPLOYMENTS:
        row = out[mode]
        assert row["ms_per_request_median"] > 0 and row["python_calls_per_request"] > 0
        assert row["device_ms_per_request"] == "not measured"


def test_time_fn_calls_warmup_plus_iters_times():
    """``bench.common.time_fn`` keeps the reference's signature
    (``benchmarks/common.py:44-54``): ``warmup`` untimed calls, then the
    median of ``iters`` timed ones, in µs; ``block`` walks nested results."""
    calls = []

    def fn(x):
        calls.append(x)
        return {"a": [torch.zeros(2), (torch.ones(1),)]}

    us = common.time_fn(fn, 7, warmup=3, iters=5)
    assert calls == [7] * 8 and us >= 0.0
    common.time_fn(fn, 1)
    assert len(calls) == 8 + 12


@pytest.mark.parametrize("tau", [5, 10])
def test_table4_large_tau_long_branch_matches_the_reference(tau):
    """Table 4's τ 5 and 10 (m = 45 and 40; U = 32 and 1,024) train through
    the SDIM wrappers on every device: on the CPU ``bse_encode`` and
    ``sdim_query`` (their plain versions) against the JAX package's Pallas
    kernels in interpret mode, and the gradient in seq through both
    backward wrappers against ``jax.grad`` of its XLA formulation, within
    fp32, on margin-screened inputs."""
    B, L, C, d = 2, 64, 3, 32
    m = tau * (48 // tau)
    rng = np.random.default_rng(tau)
    R = rng.standard_normal((m, d)).astype(np.float32)
    seq = screened_normal(rng, (B, L, d), R)
    q = screened_normal(rng, (B, C, d), R)
    mask = (rng.random((B, L)) > 0.3).astype(np.float32)
    dout = rng.standard_normal((B, C, d)).astype(np.float32)
    jseq, jq, jmask, jR = map(jnp.asarray, (seq, q, mask, R))
    jtable = jbse_encode(jseq, jmask, jR, tau, interpret=True)
    jout = jsdim_query(jq, jtable, jR, tau, interpret=True)

    def jloss(s):
        table = jsdim.bucket_table(s, jsimhash.signatures(s, jR, tau), jmask, 1 << tau)
        return jnp.sum(jsdim.fused_query(table, jsimhash.signatures(jq, jR, tau))
                       * jnp.asarray(dout))

    jgrad = jax.grad(jloss)(jseq)
    tseq = torch.from_numpy(seq).requires_grad_()
    tR = torch.from_numpy(R)
    table = bse_encode(tseq, torch.from_numpy(mask), tR, tau)
    out = sdim_query(torch.from_numpy(q), table, tR, tau)
    (out * torch.from_numpy(dout)).sum().backward()
    np.testing.assert_allclose(table.detach().numpy(), np.asarray(jtable), **FP32)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **FP32)
    np.testing.assert_allclose(tseq.grad.numpy(), np.asarray(jgrad), **FP32)


@pytest.mark.parametrize("m", [12, 48])
def test_fig5_estimator_error_of_matches_the_reference(m):
    d, L, B, tau = 32, 64, 8, 3
    R = np.array(jsimhash.make_hashes(jax.random.PRNGKey(m), m, d))
    rng = np.random.default_rng(m)
    seq = screened_normal(rng, (B, L, d), R)
    q = screened_normal(rng, (B, d), R)
    out = jsdim.sdim_attention(jnp.asarray(q), jnp.asarray(seq), None, jnp.asarray(R), tau)
    exp = jsdim.sdim_expected_attention(jnp.asarray(q), jnp.asarray(seq), None, tau)
    o, e = jsdim.l2_normalize(out), jsdim.l2_normalize(exp)
    theirs = float(jnp.mean(1.0 - jnp.sum(o * e, -1)))
    mine = fig5_m_sweep.estimator_error_of(torch.from_numpy(seq), torch.from_numpy(q),
                                           torch.from_numpy(R), tau)
    assert abs(mine - theirs) <= 1e-5, (mine, theirs)
    assert 0.0 < mine < 1.0


def test_table1_row_names_match_the_reference():
    theirs = jtable1.run(quick=True)
    mine = table1_complexity.run(quick=True, device="cpu")
    assert [r["name"] for r in mine] == [r["name"] for r in theirs]
    assert all(np.isfinite(r["us_per_call"]) and r["us_per_call"] >= 0 for r in mine)
    assert mine[-1]["derived"].startswith("t(L=1024)/t(L=256)=")


# ---------------------------------------------------------------------------
# Table 5
# ---------------------------------------------------------------------------
def _jax_embed(d):
    emb_i = jax.random.normal(jax.random.PRNGKey(11), (4000, d // 2))
    emb_c = jax.random.normal(jax.random.PRNGKey(12), (50, d // 2))
    return lambda params, items, cats: jnp.concatenate(
        [emb_i[jnp.asarray(items) % 4000], emb_c[jnp.asarray(cats) % 50]], axis=-1)


def test_table5_transmission_bytes_match_the_reference():
    T, B = 64, 16
    mine = table5_serving.ablation_rows(True, "cpu", T=T, B=B, n_req=1)
    cfg = JCTRConfig(arch="din", n_items=4000, n_cats=50, long_len=T, short_len=16,
                     mlp_hidden=(64, 32), interest=JInterestConfig(kind="sdim", m=48, tau=3))
    model = JCTRModel(cfg)
    server = JCTRServer.build(model, model.init(jax.random.PRNGKey(0)), "decoupled")
    raw = jgenerate_batch(JSyntheticCTRConfig(hist_len=T, n_items=4000, n_cats=50), 1, 0)
    user = {k: jnp.asarray(v) for k, v in raw.items() if k.startswith("hist")}
    server.handle_request("u", user, jnp.zeros(B, jnp.int32), jnp.zeros(B, jnp.int32),
                          jnp.zeros((B, 4)))
    row = {r["name"]: r["derived"] for r in mine}["table5/transmission_bytes"]
    assert row == f"{server.bse.table_bytes()}B_fixed_(L-free,bf16_wire)"
    assert {r["name"] for r in mine} >= {"table5/decoupled[cpu]", "table5/inline[cpu]",
                                         "table5/target_attention",
                                         "table5/latency_saved_vs_TA"}


def test_table5_table_bytes_and_ratio_match_the_reference():
    N, L, d = 16, 64, 32
    bench = {"backends": {}, "quantization": {}, "roofline": {}}
    table5_serving.fused_rows(True, bench, "cpu", n_users=N, reps=1)
    eng = JSDIMEngine(JEngineConfig(m=24, tau=3, d=d, backend="xla"))
    rng = np.random.default_rng(0)
    hist_i, hist_c = rng.integers(0, 4000, (N, L)), rng.integers(0, 50, (N, L))
    theirs = {}
    for dt in ("fp32", "int8"):
        srv = JBSEServer(_jax_embed(d), None, eng, capacity=N, wire_dtype=jnp.float32,
                         table_dtype=dt)
        srv.ingest_histories(list(range(N)), hist_i, hist_c)
        theirs[dt] = srv.table_bytes()
    q = bench["quantization"]
    assert (q["table_bytes_fp32"], q["table_bytes_int8"]) == (theirs["fp32"], theirs["int8"])
    assert q["bytes_ratio"] == round(theirs["fp32"] / theirs["int8"], 3)
    cpu = bench["backends"]["cpu"]
    assert cpu["max_abs_err_fused_vs_two_dispatch"] <= 1e-5
    assert set(bench["roofline"]) == {"two_dispatch", "fused", "fused_int8"}
    assert bench["roofline"]["fused_int8"] < bench["roofline"]["fused"]


def test_table5_pressure_matches_the_reference():
    """The reference's own section at its quick sizes (hot 32, L = 64 on
    ``xla``; hot 16, L = 32 on interpret-mode ``pallas``) against the
    port's ``cpu`` side at each: the tier statistics depend on the traffic
    (the same numpy draws) and the policy only."""
    theirs_bench = {"hit_rate": {}}
    theirs = {r["name"]: r["derived"] for r in jtable5.pressure_rows(True, theirs_bench)}
    for backend, sizes in (("xla", dict(hot=32, L=64)), ("pallas", {})):
        bench = {"hit_rate": {}}
        mine = {r["name"]: r["derived"]
                for r in table5_serving.pressure_rows(True, bench, "cpu", **sizes)}
        assert bench["hit_rate"]["cpu"] == theirs_bench["hit_rate"][backend]
        for what in ("hit_rate", "bytes_moved"):
            assert (mine[f"table5/pressure[cpu]/{what}"]
                    == theirs[f"table5/pressure[{backend}]/{what}"]), (backend, what)


@pytest.fixture(scope="module")
def small_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("bench")
    rows = table5_serving.run(quick=True, device="cpu", out_dir=str(out), sizes=SMALL)
    with open(out / "BENCH_serving.json") as f:
        bench = json.load(f)
    return rows, bench, out


def test_table5_run_writes_what_bench_check_accepts(small_run):
    rows, bench, out = small_run
    lines = _bench_check().check(bench)
    assert any(ln.startswith("slo:") for ln in lines)
    assert bench["schema"] == 4 and set(bench["backends"]) == set(bench["hit_rate"]) == {"cpu"}
    history = (out / "bench_history.jsonl").read_text().splitlines()
    assert len(history) == 1 and json.loads(history[0])["git_rev"] == bench["git_rev"]
    assert all(r["name"].startswith("table5/") for r in rows)
    assert {r["shards"] for r in rows if r["name"].startswith("table5/sharded/")} == {8}


def test_table5_auc_gap_and_fused_parity(small_run):
    _, bench, _ = small_run
    q = bench["quantization"]
    assert q["auc_gap"] <= 1e-3 and q["train_steps"] == 20 and q["eval_examples"] == 256
    assert bench["backends"]["cpu"]["max_abs_err_fused_vs_two_dispatch"] <= 1e-5


def test_table5_slo_and_ingest_balances(small_run):
    _, bench, _ = small_run
    slo, ing = bench["slo"], bench["ingest"]
    assert slo["n_requests"] == slo["n_served"] + slo["n_shed"] > 0
    assert ing["events_folded"] + ing["n_dropped"] >= ing["events_submitted"] > 0
    assert bench["profile"]["mem"]["cold_bytes"] > 0
    assert bench["trace"]["n_traces"] >= 1


# ---------------------------------------------------------------------------
# run.py
# ---------------------------------------------------------------------------
def test_run_prints_the_csv_of_a_module(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(run, "DRYRUN_DIR", str(tmp_path / "no_dryrun"))
    assert run.main(["--only", "fig2", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,shards,derived"
    assert [ln.split(",")[0] for ln in lines[1:]] == [
        "fig2/tau1", "fig2/tau3", "fig2/tau5", "fig2/curves_csv"]
    assert all(ln.split(",")[2] == "-" for ln in lines[1:])


def test_roofline_rows_read_the_port_dry_run(tmp_path):
    rec = dryrun.run_cell("wide-deep", "serve_p99", False, verbose=False)
    (tmp_path / rec["mesh"]).mkdir()
    with open(tmp_path / rec["mesh"] / "cell.json", "w") as f:
        json.dump(rec, f)
    (row,) = run.roofline_rows(str(tmp_path))
    assert row["name"] == f"roofline/{rec['mesh']}/wide-deep/serve_p99"
    assert "fits=True" in row["derived"] and row["us_per_call"] > 0
