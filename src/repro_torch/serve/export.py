"""Prometheus text-format exposition for the serving runtime; the port's
own copy of ``repro/serve/export.py``.

``render_prometheus`` turns one atomic ``MetricsRegistry`` cut (plus,
optionally, a ``health_snapshot`` dict) into the classic Prometheus text
exposition format — the string a ``/metrics`` endpoint would return and
any Prometheus scraper can ingest:

  * counters  -> ``# TYPE <name> counter`` + one sample;
  * gauges    -> ``# TYPE <name> gauge`` + one sample;
  * histograms-> ``# TYPE <name> histogram`` + cumulative
    ``_bucket{le="..."}`` samples, ``_sum`` and ``_count``. Only bucket
    boundaries that change the cumulative count are emitted (plus the
    mandatory ``+Inf``) — Prometheus allows any subset of boundaries, and
    the registry's ~77 log-spaced buckets would otherwise bloat every
    scrape;
  * health    -> ``<prefix>_health_live`` / ``_health_ready`` 0|1 gauges
    and one ``<prefix>_health_check_ok{check="..."}`` series per readiness
    check.

Zero is a value, not an absence: a registered-but-never-observed histogram
still emits its mandatory ``+Inf`` bucket plus ``_sum 0`` / ``_count 0``,
and a zero-valued gauge (e.g. ``mem.cold_bytes`` before the first spill)
emits an explicit ``0`` sample — scrapers distinguish "measured zero" from
"series missing", and rate()/increase() need the zero point. Pinned by
regression tests in tests/test_export.py for the JAX package's copy.

Metric names are sanitized to the Prometheus charset (``layer.metric_ms``
-> ``<prefix>_layer_metric_ms``). The renderer is read-only and
allocation-light — safe to call from a sidecar thread on a live registry
(the underlying ``export_state``/``snapshot`` are one-lock atomic cuts).
tests/test_torch_runtime.py holds its output equal to the JAX package's.
"""
from __future__ import annotations

import re
from typing import Optional

from repro_torch.serve.metrics import MetricsRegistry

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _sanitize(name: str) -> str:
    out = _NAME_RE.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _fmt(v: float) -> str:
    """Prometheus sample value: integers render bare, floats via repr."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int) or (isinstance(v, float) and v.is_integer()):
        return str(int(v))
    return repr(float(v))


def render_prometheus(metrics: MetricsRegistry, health: Optional[dict] = None,
                      prefix: str = "repro") -> str:
    """Render ``metrics`` (and an optional ``health_snapshot(server)``
    dict) as Prometheus exposition text. One atomic registry cut — the
    counters in one scrape are mutually consistent."""
    state = metrics.export_state()
    lines: list[str] = []

    for name in sorted(state["counters"]):
        n = f"{prefix}_{_sanitize(name)}"
        lines.append(f"# TYPE {n} counter")
        lines.append(f"{n} {_fmt(state['counters'][name])}")

    for name in sorted(state["gauges"]):
        n = f"{prefix}_{_sanitize(name)}"
        lines.append(f"# TYPE {n} gauge")
        lines.append(f"{n} {_fmt(state['gauges'][name])}")

    for name in sorted(state["histograms"]):
        h = state["histograms"][name]
        n = f"{prefix}_{_sanitize(name)}"
        lines.append(f"# TYPE {n} histogram")
        bounds, buckets = h["bounds"], h["buckets"]
        cum = 0
        for i, cnt in enumerate(buckets[:-1]):
            if cnt:
                cum += cnt
                lines.append(f'{n}_bucket{{le="{bounds[i]!r}"}} {cum}')
        cum += buckets[-1]                       # overflow bucket
        lines.append(f'{n}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{n}_sum {_fmt(h['sum'])}")
        lines.append(f"{n}_count {h['count']}")

    if health is not None:
        for key in ("live", "ready"):
            n = f"{prefix}_health_{key}"
            lines.append(f"# TYPE {n} gauge")
            lines.append(f"{n} {_fmt(bool(health.get(key)))}")
        checks = health.get("checks", {})
        if checks:
            n = f"{prefix}_health_check_ok"
            lines.append(f"# TYPE {n} gauge")
            for cname in sorted(checks):
                lines.append(
                    f'{n}{{check="{_sanitize(cname)}"}} '
                    f"{_fmt(bool(checks[cname].get('ok')))}")

    return "\n".join(lines) + "\n"
