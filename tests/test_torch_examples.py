"""The port's four examples (``src/repro_torch/examples/{quickstart,
serving_bse,tiered_serving,train_ctr}.py``) run on the CPU at small
arguments, as ``tests/test_torch_lm.py`` runs ``lm_decode_sdim``: each
example's own asserts hold (decoupled against inline within 0.1 before a
user's events; the micro-batched burst against per-user requests within
1e-4; a restored tiered server bit-identical), its printed account
parses, and ``train_ctr`` killed by its preemption event and run again
resumes from its checkpoint to the same parameters, bit for bit, as a run
that was never stopped. Without ``--device cpu`` an example asks for the
card, and raises where there is none.
"""
import os
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.examples import quickstart, serving_bse, tiered_serving, train_ctr

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.abspath(os.path.join(HERE, "..", "src"))
CPU = ["--device", "cpu"]
TRAIN = ["--batch", "8", "--n-items", "2000", "--long-len", "32", "--embed-dim", "16"] + CPU


def test_quickstart_runs_at_its_defaults(capsys):
    out = quickstart.main(CPU)
    text = capsys.readouterr().out
    assert out["table_shape"] == (1, 16, 8, 128) and out["interest_shape"] == (1, 8, 128)
    assert "bytes on the wire (fixed — independent of L=1024)" in text
    sampled = float(re.search(r"cos\(SDIM sampled, exact TA\)\s+= ([\d.-]+)", text)[1])
    theory = float(re.search(r"cos\(SDIM Eq.14,\s+exact TA\)\s+= ([\d.-]+)", text)[1])
    assert (sampled, theory) == (round(out["cos_sampled"], 4), round(out["cos_theory"], 4))
    assert 0.0 < sampled <= 1.0 and 0.5 < theory <= 1.0


def test_quickstart_runs_as_a_module():
    run = subprocess.run([sys.executable, "-m", "repro_torch.examples.quickstart", *CPU],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=SRC))
    assert run.returncode == 0, run.stderr[-2000:]
    assert "user interest per candidate: (1, 8, 128)" in run.stdout


def test_serving_bse_holds_its_asserts(capsys):
    out = serving_bse.main(["--T", "256", "--candidates", "64", "--requests", "6",
                            "--users", "3", *CPU])
    text = capsys.readouterr().out
    assert len(re.findall(r"^req \d+: user \d+ -> top candidate \d+", text, re.M)) == 6
    assert out["decoupled_inline_gap"] < 0.1 and out["burst_gap"] < 1e-4
    assert "scores match the per-user path" in text
    fetched = re.search(r"bytes moved BSE->CTR: (\d+) \((\d+) fetches\); events ingested: (\d+)",
                        text)
    assert int(fetched[3]) == 6 and int(fetched[2]) == 6
    assert out["events"] == 6 + 2 * 3                     # the requests' events, two batches
    assert re.search(r"batched event ingest: 3 events in [\d.]+ ms", text)


def test_tiered_serving_restores_bit_identically(capsys):
    out = tiered_serving.main(["--hot", "4", "--users", "16", "--T", "32", "--bursts", "3", *CPU])
    text = capsys.readouterr().out
    assert out["restored_users"] == 16 and sum(out["tiers"].values()) == 16
    assert out["tiers"]["hot"] <= 4 and out["tiers"]["cold"] > 0
    assert "fetch_many bit-identical, zero histories re-encoded" in text
    assert re.search(r"ingested 16 users -> tiers \{'hot': \d+, 'warm': \d+, 'cold': \d+\}", text)
    assert 0.0 <= out["hit_rate"] <= 1.0
    with pytest.raises(SystemExit):
        tiered_serving.main(["--hot", "16", "--users", "20", *CPU])


def test_train_ctr_resumes_after_preemption(tmp_path, capsys):
    whole = train_ctr.main(["--steps", "6", "--ckpt", str(tmp_path / "whole"), *TRAIN])
    assert whole["stopped_at"] == 6
    cut = tmp_path / "cut"
    first = train_ctr.main(["--steps", "6", "--ckpt", str(cut), *TRAIN], stop_after=3)
    assert first["stopped_at"] == 3
    assert os.path.isdir(cut) and os.listdir(cut)
    second = train_ctr.main(["--steps", "6", "--ckpt", str(cut), *TRAIN])
    assert second["stopped_at"] == 6
    text = capsys.readouterr().out
    assert "stopped at step 3; straggler flags" in text and "stopped at step 6" in text
    assert re.search(r"step\s+5\s+loss [\d.]+\s+lr [\d.]+", text)
    for (name, a), (_, b) in zip(whole["model"].named_parameters(),
                                 second["model"].named_parameters()):
        assert torch.equal(a, b), name
    assert whole["history"][-1][1]["loss"] == second["history"][-1][1]["loss"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="the card is here: nothing to refuse")
@pytest.mark.parametrize("example", [quickstart, serving_bse, tiered_serving])
def test_examples_default_to_the_card(example):
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        example.main([])
