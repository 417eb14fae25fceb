"""CTR server (paper §4.4, Fig. 1): scores C candidate items per request.

Counterpart of ``repro/serve/ctr_server.py`` for three deployments (the
paper's §4.4 serving comparison):

- ``"decoupled"``: the user's long-term state comes from the BSE server's
  table store, so a request costs candidate hashing only. A burst of N
  requests becomes ONE ``fetch_many`` gather plus ONE scoring pass over the
  padded (N, C_max) candidate block — or, with ``fused=True``, ONE
  ``sdim_fused_serve`` launch on the BSE side that hands back only the
  (N, C, e) interest vectors. Missing users are encoded first, in one
  batched ``ingest_histories`` (on an async-ingest server: enqueued, and
  scored with zero long-term interest until the writer commits them).
- ``"inline"``: no BSE server; every burst ships the full (N, L) histories
  and the long branch scores them raw — ONE ``bse_serve`` launch for an
  ``sdim`` model (SDIM without the BSE split, the paper's ablation), the
  interest module for any other kind (the Table 2/3 baselines: the
  retrieval kinds launch ``target_attention_flash`` once per burst over
  the folded (N·C, k) retrieved rows).
- ``"target_attention"``: the same raw path for a model of interest kind
  ``target`` (DIN over the whole history, ONE ``target_attention_flash``
  launch per burst).

Requests are served one at a time (``handle_request``, a burst of one) or
micro-batched (``handle_requests``). The production runtime of the
reference comes with ``build``'s arguments: the tiered store, async ingest,
admission control (``serve/admission.py``: overload sheds, each shed
request gets an explicit ``None`` score and is counted), metrics
(``ctr.request_ms`` with trace exemplars, ``ctr.requests``, ``ctr.shed``)
and tracing (spans ``ctr.request`` > ``ctr.admission`` / ``ctr.assemble``
/ ``ctr.ingest_missing`` / BSE reads / ``ctr.score``).

The scoring step synchronizes its stream where the reference blocks until
its scores are ready, then the scores cross to the host in one copy; no
span adds a synchronize. The reference renames a ``ctr.score`` span to
``ctr.jit_compile`` when the dispatch grew its jit cache; the port has no
jit cache, and renames the span only for the dispatch that built the
kernel library (``kernels/_build.load``'s first call).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import _build
from repro_torch.models.ctr import CTRModel
from repro_torch.serve.admission import AdmissionController
from repro_torch.serve.bse_server import BSEServer, sync_stream
from repro_torch.serve.metrics import MetricsRegistry, observe_ms
from repro_torch.serve.tiered_store import is_tiered
from repro_torch.serve.tracing import NOOP_SPAN, Tracer

MODES = ("decoupled", "inline", "target_attention")


@dataclasses.dataclass
class ServeStats:
    n_requests: int = 0        # requests actually served
    n_shed: int = 0            # requests refused by admission (never served)
    total_time_s: float = 0.0
    fetch_time_s: float = 0.0

    @property
    def ms_per_request(self) -> float:
        return 1e3 * self.total_time_s / max(self.n_requests, 1)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _embed(model: CTRModel, items, cats) -> torch.Tensor:
    """The BSE server's ``embed_fn``: ``params`` is the model itself."""
    dev = model.item_emb.weight.device
    return model._embed_behaviors(torch.as_tensor(items, device=dev),
                                  torch.as_tensor(cats, device=dev))


class CTRServer:
    @classmethod
    def build(cls, model: CTRModel, params: Optional[dict] = None,
              mode: str = "decoupled", *, mesh: Any = None, capacity: int = 64,
              wire_dtype: torch.dtype = torch.bfloat16,
              hot_capacity: Optional[int] = None, store_dir: Optional[str] = None,
              policy: Optional[str] = None, warm_capacity: Optional[int] = None,
              table_dtype: Any = torch.float32, fused: bool = False,
              async_ingest: bool = False, queue_depth: int = 1024,
              max_staleness: int = 64, max_concurrency: Optional[int] = None,
              rate_limit: Optional[float] = None, rate_burst: Optional[float] = None,
              cold_deadline_s: Optional[float] = None,
              metrics: Optional[MetricsRegistry] = None,
              tracer: Optional[Tracer] = None, clock=None,
              device: DeviceLike = "cuda") -> "CTRServer":
        """The server on ``device``; for ``mode="decoupled"`` it wires the
        model's behavior embedding and hash family R into a ``BSEServer``
        (the other modes have none). ``params`` (the JAX package's CTR
        params pytree as numpy arrays) is loaded into the model first when
        given (``weights.load_jax_params``); ``None`` serves the model's own
        weights. ``mesh`` (a ``MeshCtx`` or a list of devices) shards the
        BSE table store over its model axis (decoupled mode only).

        ``table_dtype`` is the BSE storage dtype (fp32 | bf16 | int8 |
        fp8); ``fused=True`` serves micro-batches through
        ``BSEServer.serve_candidates``. Any of ``hot_capacity``/
        ``store_dir``/``policy``/``warm_capacity`` selects the tiered store;
        ``async_ingest=True`` runs BSE ingestion off the request path
        (bounded by ``queue_depth`` and ``max_staleness``).
        ``max_concurrency`` bounds concurrent bursts (an excess burst sheds
        whole); ``rate_limit`` (requests/s, headroom ``rate_burst``)
        token-bucket-limits admission (the tail of an over-budget burst
        sheds). ``cold_deadline_s`` arms the cold-tier circuit breaker.
        ``metrics`` is the shared registry (created when omitted),
        ``tracer`` threads per-request spans through every layer, ``clock``
        injects a virtual clock for tests."""
        dev = resolve_device(device)
        tiered = is_tiered(hot_capacity, store_dir, policy, warm_capacity)
        metrics = MetricsRegistry() if metrics is None else metrics
        for flag, what in ((async_ingest, "async ingestion feeds"),
                           (mesh is not None, "mesh shards"),
                           (tiered, "hot_capacity/store_dir/policy tier"),
                           (fused, "fused serving reads")):
            if mode != "decoupled" and flag:
                raise ValueError(f"{what} the BSE table store, which only the "
                                 f"decoupled deployment has (mode={mode!r})")
        if cold_deadline_s is not None and not tiered:
            raise ValueError(
                "cold_deadline_s arms the cold-tier circuit breaker, which "
                "needs the tiered store (pass hot_capacity=/store_dir=/"
                "policy=/warm_capacity=)")
        if params is not None:
            from repro_torch.weights import load_jax_params
            load_jax_params(model, params)
        model.to(dev)
        bse = None
        if mode == "decoupled":
            bse = BSEServer(_embed, model, model.engine, R=model.interest.R,
                            wire_dtype=wire_dtype, capacity=capacity, mesh=mesh,
                            hot_capacity=hot_capacity, store_dir=store_dir,
                            policy=policy, warm_capacity=warm_capacity,
                            table_dtype=table_dtype, async_ingest=async_ingest,
                            queue_depth=queue_depth, max_staleness=max_staleness,
                            metrics=metrics, tracer=tracer,
                            cold_deadline_s=cold_deadline_s, clock=clock, device=dev)
        admission = None
        if max_concurrency is not None or rate_limit is not None:
            admission = AdmissionController(
                max_concurrency=max_concurrency, rate=rate_limit, burst=rate_burst,
                clock=time.monotonic if clock is None else clock)
        return cls(model, bse, mode=mode, fused=fused, admission=admission,
                   metrics=metrics, tracer=tracer)

    def __init__(self, model: CTRModel, bse_server: Optional[BSEServer] = None,
                 mode: str = "decoupled", fused: bool = False,
                 admission: Optional[AdmissionController] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None):
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} is not one of {MODES}")
        if mode == "decoupled" and bse_server is None:
            raise ValueError("the decoupled deployment needs a BSE server")
        self.model = model
        self.bse = bse_server
        self.mode = mode
        self.fused = fused
        self.admission = admission
        self.metrics = metrics if metrics is not None else (
            bse_server.metrics if bse_server is not None else None)
        self.tracer = tracer
        self.device = model.item_emb.weight.device
        self.stats = ServeStats()

    def handle_request(self, user: Any, user_batch: dict, cand_items, cand_cats, ctx):
        """A burst of ONE through ``handle_requests`` (same admission,
        timing and spans). ``user_batch``: hist_* (1, L) arrays. Returns the
        (C,) scores, or ``None`` when admission shed the request."""
        return self.handle_requests([(user, user_batch, cand_items, cand_cats, ctx)])[0]

    def handle_requests(self, requests) -> list:
        """Micro-batched serving: ``requests`` is a list of ``(user,
        user_batch, cand_items, cand_cats, ctx)`` tuples with host arrays.
        Candidate lists are right-padded to the burst max and the padded
        scores sliced off, so callers get one (C_i,) numpy array per
        request. ``[]`` in, ``[]`` out.

        With an ``AdmissionController`` attached, overload SHEDS instead of
        queueing: a burst arriving while ``max_concurrency`` bursts are in
        flight is refused whole; a burst over the token-bucket budget is
        served as an admitted prefix. Every shed request still gets its
        list slot, an explicit ``None``, and is counted (``stats.n_shed``,
        ``ctr.shed``)."""
        if not requests:
            return []
        tr = self.tracer
        if tr is not None and tr.enabled:
            root = tr.span("ctr.request", n=len(requests))
        else:
            root, tr = NOOP_SPAN, None
        with root:
            adm = self.admission
            if adm is None:
                return self._handle_admitted(requests)
            with (tr.span("ctr.admission") if tr is not None else NOOP_SPAN) as asp:
                entered = adm.enter()
                k = adm.admit(len(requests)) if entered else 0
                asp.set(offered=len(requests), admitted=k)
            if not entered:
                self._note_shed(len(requests))
                adm.shed_all(len(requests))
                if tr is not None:
                    tr.flag("shed")
                return [None] * len(requests)
            try:
                if k < len(requests):
                    self._note_shed(len(requests) - k)
                    if tr is not None:
                        tr.flag("shed")
                out = self._handle_admitted(requests[:k]) if k else []
                return out + [None] * (len(requests) - k)
            finally:
                adm.exit()

    def _note_shed(self, n: int) -> None:
        self.stats.n_shed += n
        if self.metrics is not None:
            self.metrics.counter("ctr.shed").inc(n)

    def _dispatch(self, fn, *args, **kwargs) -> torch.Tensor:
        """The scoring pass, its stream synchronized. When tracing, the pass
        that built the kernel library is recorded as ``ctr.jit_compile``
        (and counted in ``ctr.jit_compiles``) instead of ``ctr.score``."""
        tr = self.tracer
        if tr is None or not tr.enabled:
            scores = fn(*args, **kwargs)
            sync_stream(scores)
            return scores
        built = _build.loaded()
        with tr.span("ctr.score") as sp:
            scores = fn(*args, **kwargs)
            sync_stream(scores)
            if not built and _build.loaded():
                sp.name = "ctr.jit_compile"
                if self.metrics is not None:
                    self.metrics.counter("ctr.jit_compiles").inc()
        return scores

    @torch.no_grad()
    def _handle_admitted(self, requests) -> list:
        tr = self.tracer
        if tr is not None and not tr.enabled:
            tr = None
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
        with (tr.span("ctr.assemble", n=len(requests), c_max=c_max)
              if tr is not None else NOOP_SPAN):
            ci, cc, ctx = stack(2), stack(3), stack(4)
            lo = -self.model.cfg.short_len if self.mode == "decoupled" else 0
            hist = {k: torch.as_tensor(np.concatenate([_host(r[1][k])[:, lo:]
                                                       for r in requests]), device=dev)
                    for k in ("hist_items", "hist_cats", "hist_mask")}

        score = self.model.score_candidates_many
        if self.mode != "decoupled":
            scores = self._dispatch(score, hist, ci, cc, ctx)
        else:
            tf0 = time.perf_counter()
            missing = {}
            for r in requests:
                if r[0] not in self.bse.tables:
                    missing.setdefault(r[0], r[1])
            if missing:
                with (tr.span("ctr.ingest_missing", n=len(missing))
                      if tr is not None else NOOP_SPAN):
                    self.bse.ingest_histories(
                        list(missing),
                        np.concatenate([_host(b["hist_items"]) for b in missing.values()]),
                        np.concatenate([_host(b["hist_cats"]) for b in missing.values()]),
                        np.concatenate([_host(b["hist_mask"]) for b in missing.values()]))
            if self.fused:
                interest = self.bse.serve_candidates(users, self.model._embed_behaviors(ci, cc))
                self.stats.fetch_time_s += time.perf_counter() - tf0
                scores = self._dispatch(score, hist, ci, cc, ctx, interest=interest)
            else:
                tables = self.bse.fetch_many(users)
                self.stats.fetch_time_s += time.perf_counter() - tf0
                scores = self._dispatch(score, hist, ci, cc, ctx, bucket_tables=tables)
        host = scores.cpu().numpy()          # one device -> host copy
        dt = time.perf_counter() - t0
        self.stats.total_time_s += dt
        self.stats.n_requests += len(requests)
        trace_id = None
        if tr is not None:
            cur = tr.current()
            trace_id = cur.trace_id if cur is not None else None
            tr.annotate(request_ms=1e3 * dt)
        if self.metrics is not None:
            observe_ms(self.metrics, "ctr.request_ms", dt, exemplar=trace_id)
            self.metrics.counter("ctr.requests").inc(len(requests))
        return [host[i, :c] for i, c in enumerate(n_cands)]
