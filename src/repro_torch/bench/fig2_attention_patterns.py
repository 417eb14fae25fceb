"""Figure 2 — SDIM's collision kernel (1−arccos(x)/π)^τ vs target
attention's exp((x−1)/0.5), over x = cos θ ∈ [−1, 1], on the port:

    python -m repro_torch.bench.fig2_attention_patterns

Counterpart of ``benchmarks/fig2_attention_patterns.py`` (numpy only; a
copy): reports the cosine similarity and max deviation between the two
(normalized) weight curves and writes the curves to
``results/torch/fig2_curves.csv`` under the working directory.
"""
from __future__ import annotations

import json
import os

import numpy as np

CSV = os.path.join("results", "torch", "fig2_curves.csv")


def run(quick: bool = True):
    x = np.linspace(-1, 1, 201)
    curves = {"x": x, "ta": np.exp((x - 1) / 0.5)}
    rows = []
    for tau in (1, 3, 5):
        w = (1 - np.arccos(x) / np.pi) ** tau
        curves[f"sdim_tau{tau}"] = w
        cos = float((w * curves["ta"]).sum()
                    / (np.linalg.norm(w) * np.linalg.norm(curves["ta"])))
        wn = w / w.sum()
        tn = curves["ta"] / curves["ta"].sum()
        rows.append({"name": f"fig2/tau{tau}", "us_per_call": 0.0,
                     "derived": f"cos_sim_to_softmax={cos:.4f};"
                                f"max_abs_dev={np.abs(wn - tn).max():.4f}"})
    os.makedirs(os.path.dirname(CSV), exist_ok=True)
    with open(CSV, "w") as f:
        keys = list(curves)
        f.write(",".join(keys) + "\n")
        for i in range(len(x)):
            f.write(",".join(f"{curves[k][i]:.6f}" for k in keys) + "\n")
    rows.append({"name": "fig2/curves_csv", "us_per_call": 0.0, "derived": CSV})
    return rows


if __name__ == "__main__":
    for row in run():
        print(json.dumps(row))
