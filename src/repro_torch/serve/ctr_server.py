"""CTR server (paper §4.4, Fig. 1): scores C candidate items per request.

Counterpart of ``repro/serve/ctr_server.py`` for three deployments (the
paper's §4.4 serving comparison):

- ``"decoupled"``: the user's long-term state comes from the BSE server's
  table store, so a request costs candidate hashing only. A burst of N
  requests becomes ONE ``fetch_many`` gather plus ONE scoring pass over the
  padded (N, C_max) candidate block — or, with ``fused=True``, ONE
  ``sdim_fused_serve`` launch on the BSE side that hands back only the
  (N, C, e) interest vectors. Missing users are encoded first, in one
  batched ``ingest_histories``.
- ``"inline"``: no BSE server; every burst ships the full (N, L) histories
  and the long branch scores them raw — ONE ``bse_serve`` launch for an
  ``sdim`` model (SDIM without the BSE split, the paper's ablation), the
  interest module for any other kind (the Table 2/3 baselines: the
  retrieval kinds launch ``target_attention_flash`` once per burst over
  the folded (N·C, k) retrieved rows).
- ``"target_attention"``: the same raw path for a model of interest kind
  ``target`` (DIN over the whole history, ONE ``target_attention_flash``
  launch per burst).

Requests are served one at a time (``handle_request``) or micro-batched
(``handle_requests``). Admission control, metrics and tracing are not
ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.ctr import CTRModel
from repro_torch.serve.bse_server import BSEServer

MODES = ("decoupled", "inline", "target_attention")


@dataclasses.dataclass
class ServeStats:
    n_requests: int = 0
    total_time_s: float = 0.0
    fetch_time_s: float = 0.0

    @property
    def ms_per_request(self) -> float:
        return 1e3 * self.total_time_s / max(self.n_requests, 1)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class CTRServer:
    @classmethod
    def build(cls, model: CTRModel, params: Optional[dict] = None,
              mode: str = "decoupled", *, capacity: int = 64,
              wire_dtype: torch.dtype = torch.bfloat16, table_dtype: Any = torch.float32,
              fused: bool = False, device: DeviceLike = "cuda") -> "CTRServer":
        """The server on ``device``; for ``mode="decoupled"`` it wires the
        model's behavior embedding and hash family R into a ``BSEServer``
        (the other modes have none). ``params`` (the JAX package's CTR
        params pytree as numpy arrays) is loaded into the model first when
        given (``weights.load_jax_params``); ``None`` serves the model's own
        weights. ``table_dtype`` is the BSE storage dtype (fp32 | bf16 |
        int8 | fp8); ``fused=True`` serves micro-batches through
        ``BSEServer.serve_candidates``."""
        dev = resolve_device(device)
        if mode != "decoupled" and fused:
            raise ValueError(
                f"fused serving reads the BSE table store, which only the "
                f"decoupled deployment has (mode={mode!r})")
        if params is not None:
            from repro_torch.weights import load_jax_params
            load_jax_params(model, params)
        model.to(dev)
        if mode != "decoupled":
            return cls(model, None, mode=mode)

        def embed(items, cats):
            return model._embed_behaviors(torch.as_tensor(items, device=dev),
                                          torch.as_tensor(cats, device=dev))

        bse = BSEServer(embed, model.engine, R=model.interest.R, wire_dtype=wire_dtype,
                        capacity=capacity, table_dtype=table_dtype, device=dev)
        return cls(model, bse, mode=mode, fused=fused)

    def __init__(self, model: CTRModel, bse_server: Optional[BSEServer] = None,
                 mode: str = "decoupled", fused: bool = False):
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} is not one of {MODES}")
        if mode == "decoupled" and bse_server is None:
            raise ValueError("the decoupled deployment needs a BSE server")
        self.model = model
        self.bse = bse_server
        self.mode = mode
        self.fused = fused
        self.device = model.item_emb.weight.device
        self.stats = ServeStats()

    def handle_request(self, user: Any, user_batch: dict, cand_items, cand_cats, ctx):
        """A burst of ONE through ``handle_requests``. ``user_batch``: hist_*
        (1, L) arrays. Returns the (C,) scores."""
        return self.handle_requests([(user, user_batch, cand_items, cand_cats, ctx)])[0]

    @torch.no_grad()
    def handle_requests(self, requests) -> list:
        """Micro-batched serving: ``requests`` is a list of ``(user,
        user_batch, cand_items, cand_cats, ctx)`` tuples with host arrays.
        Candidate lists are right-padded to the burst max and the padded
        scores sliced off, so callers get one (C_i,) numpy array per
        request. ``[]`` in, ``[]`` out."""
        if not requests:
            return []
        t0 = time.perf_counter()
        dev = self.device
        users = [r[0] for r in requests]
        n_cands = [len(r[2]) for r in requests]
        c_max = max(n_cands)

        def stack(i):
            rows = []
            for r, c in zip(requests, n_cands):
                x = _host(r[i])
                rows.append(np.pad(x, [(0, c_max - c)] + [(0, 0)] * (x.ndim - 1)))
            return torch.as_tensor(np.stack(rows), device=dev)

        # one upload per operand; decoupled scoring reads only the short
        # window, the raw path the full history
        ci, cc, ctx = stack(2), stack(3), stack(4)
        lo = -self.model.cfg.short_len if self.mode == "decoupled" else 0
        hist = {k: torch.as_tensor(np.concatenate([_host(r[1][k])[:, lo:] for r in requests]),
                                   device=dev)
                for k in ("hist_items", "hist_cats", "hist_mask")}

        if self.mode != "decoupled":
            return self._finish(t0, n_cands,
                                self.model.score_candidates_many(hist, ci, cc, ctx))
        tf0 = time.perf_counter()
        missing = {}
        for r in requests:
            if r[0] not in self.bse.store:
                missing.setdefault(r[0], r[1])
        if missing:
            self.bse.ingest_histories(
                list(missing),
                np.concatenate([_host(b["hist_items"]) for b in missing.values()]),
                np.concatenate([_host(b["hist_cats"]) for b in missing.values()]),
                np.concatenate([_host(b["hist_mask"]) for b in missing.values()]))
        if self.fused:
            target_e = self.model._embed_behaviors(ci, cc)
            interest = self.bse.serve_candidates(users, target_e)
            self.stats.fetch_time_s += time.perf_counter() - tf0
            scores = self.model.score_candidates_many(hist, ci, cc, ctx, interest=interest)
        else:
            tables = self.bse.fetch_many(users)
            self.stats.fetch_time_s += time.perf_counter() - tf0
            scores = self.model.score_candidates_many(hist, ci, cc, ctx,
                                                      bucket_tables=tables)
        return self._finish(t0, n_cands, scores)

    def _finish(self, t0: float, n_cands: list, scores: torch.Tensor) -> list:
        host = scores.cpu().numpy()          # one device -> host copy, synchronizes
        self.stats.total_time_s += time.perf_counter() - t0
        self.stats.n_requests += len(n_cands)
        return [host[i, :c] for i, c in enumerate(n_cands)]
