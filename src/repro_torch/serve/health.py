"""Liveness/readiness surface for the serving runtime (the health half of
the production surface; the metrics half is ``serve/metrics.py``).

The port's own copy of ``repro/serve/health.py``, over the port's tiered
store: the same checks, the same dicts.

``health_snapshot(server)`` inspects a ``CTRServer`` or ``BSEServer`` (or
a bare ``AsyncIngestor``/``TieredTableStore``) and returns one plain-dict
probe result::

    {"live": bool, "ready": bool,
     "checks": {name: {"ok": bool, ...detail}}}

Checks (each only present when the corresponding subsystem exists):

  * ``writer``        — the async writer loop, if started, must be alive.
    A dead writer with work still queued is the one condition that flips
    **liveness**: the process can no longer make ingest progress and
    should be restarted.
  * ``ingest_queue``  — queue depth vs ``queue_depth`` bound. A full
    queue means new submits are dropping (counted): not ready.
  * ``staleness``     — max observed per-user fold backlog vs
    ``max_staleness``. Over the bound means the write path broke its
    contract: not ready.
  * ``hot_tier``      — hot-tier fill fraction (pressure report; over
    capacity would be a residency-engine bug): not ready if violated.
  * ``cold_breaker``  — circuit state. An OPEN breaker still serves
    (degrade-to-miss), so it does NOT flip readiness; it is surfaced with
    ``ok=False`` so operators see the cold tier is sick.
  * ``drops`` / ``nonfinite`` — counted-degradation telemetry
    (backpressure drops are by-design and stay ``ok=True``; nonfinite
    ingest rows mark ``ok=False`` — something upstream is poisoned —
    without flipping readiness, since the store sanitized them).

``ready`` is the conjunction of the readiness-bearing checks above;
``live`` is the writer check alone. The dict is JSON-serializable as-is
(the launcher prints it; tests pin the degradation semantics).
"""
from __future__ import annotations

from typing import Any

from repro_torch.serve.tiered_store import TieredTableStore

# checks that flip readiness when not ok (breaker/nonfinite/drops are
# surfaced but do not unready a server that still answers correctly)
_READINESS_CHECKS = ("writer", "ingest_queue", "staleness", "hot_tier")


def _bse_of(server: Any):
    """CTRServer -> its BSEServer; BSEServer/other -> itself-or-None."""
    bse = getattr(server, "bse", None)
    if bse is not None:
        return bse
    # a BSEServer (or bare runtime/store) was passed directly
    return server if hasattr(server, "fetcher") else None


def health_snapshot(server: Any) -> dict:
    checks: dict[str, dict] = {}
    bse = _bse_of(server)
    runtime = getattr(bse, "async_ingest", None) if bse is not None else \
        (server if hasattr(server, "drain_once") else None)
    store = getattr(bse, "store", None) if bse is not None else \
        (server if isinstance(server, TieredTableStore) else None)

    if runtime is not None:
        thread = runtime._thread
        started = thread is not None
        alive = bool(thread.is_alive()) if started else True
        depth = runtime.stats.queue_depth
        # a dead writer is only fatal when it strands queued work — an
        # unstarted or cleanly-stopped runtime is driven inline
        checks["writer"] = {"ok": alive or depth == 0,
                            "started": started, "alive": alive}
        checks["ingest_queue"] = {"ok": depth < runtime.queue_depth,
                                  "depth": depth,
                                  "bound": runtime.queue_depth}
        smax = runtime.stats.staleness_max()
        checks["staleness"] = {"ok": smax <= runtime.max_staleness,
                               "max_observed": smax,
                               "bound": runtime.max_staleness}
        checks["drops"] = {"ok": True,          # counted backpressure
                           "n_dropped": runtime.stats.n_dropped,
                           "n_deduped": runtime.stats.n_deduped}

    if isinstance(store, TieredTableStore):
        fill = len(store.hot) / store.hot_capacity
        checks["hot_tier"] = {"ok": fill <= 1.0, "fill": fill,
                              "capacity": store.hot_capacity,
                              "sizes": store.tier_sizes()}
        if store.breaker is not None:
            snap = store.breaker.snapshot()
            checks["cold_breaker"] = {
                "ok": snap["state"] != "open",
                "n_degraded": store.stats.n_degraded, **snap}

    if store is not None and hasattr(store, "n_nonfinite"):
        checks["nonfinite"] = {"ok": store.n_nonfinite == 0,
                               "n_nonfinite": store.n_nonfinite,
                               "n_saturated": getattr(store, "n_saturated",
                                                      0)}

    admission = getattr(server, "admission", None)
    if admission is not None:
        checks["admission"] = {"ok": True,      # sheds are by-design
                               "inflight": admission.inflight,
                               "n_shed": admission.stats.n_shed,
                               "n_admitted": admission.stats.n_admitted}

    live = checks.get("writer", {"ok": True})["ok"]
    ready = live and all(checks[name]["ok"] for name in _READINESS_CHECKS
                         if name in checks)
    return {"live": live, "ready": ready, "checks": checks}
