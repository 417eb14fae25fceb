"""Quantized bucket-table storage: per-row scales, quantize-on-write.

Counterpart of ``repro/serve/quant.py``. Each bucket row ``T[g, u, :]`` is
stored as

    q[g, u, :]  = round(T[g, u, :] / scale[g, u])   in int8 or fp8 (e4m3)
    scale[g, u] = max|T[g, u, :]| / QMAX              (127 or 448)

and read back as ``q * scale``. Rounding is half-to-even (``torch.round``,
as ``jnp.round``, for int8; the cast itself for fp8); an all-zero row gets
scale 0 and round-trips exactly; a row holding inf/NaN is zeroed (payload
and scale) and counted instead of emitting ``scale = inf``. Storage dtypes:
fp32, bf16, int8, fp8.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

TABLE_DTYPES: dict[str, torch.dtype] = {
    "fp32": torch.float32,
    "bf16": torch.bfloat16,
    "int8": torch.int8,
    "fp8": torch.float8_e4m3fn,
}

# largest exactly-representable magnitude per quantized dtype
_QMAX = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0}


def resolve_table_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    """``'fp32'``/``'bf16'``/``'int8'``/``'fp8'`` -> torch dtype; a dtype
    passes through."""
    if isinstance(name, torch.dtype):
        return name
    if name in TABLE_DTYPES:
        return TABLE_DTYPES[name]
    raise ValueError(f"table dtype {name!r} not available; have {sorted(TABLE_DTYPES)}")


def is_quantized(dtype: torch.dtype) -> bool:
    """True for storage dtypes that need per-row scales."""
    return dtype in _QMAX


def qmax(dtype: torch.dtype) -> float:
    return _QMAX[dtype]


def _quantize(rows: torch.Tensor, dtype: torch.dtype):
    """Shared body: (payload, scales, per-row finite mask)."""
    rows = rows.float()
    q = qmax(dtype)
    amax = rows.abs().amax(dim=-1)
    ok = torch.isfinite(amax)
    # amax × fp32(1/q): XLA compiles the JAX package's ``amax / q`` to this
    # product (for 127 and for 448), so both give the same scale bits
    scales = torch.where(ok, amax, torch.zeros_like(amax)) * float(np.float32(1.0 / q))
    pos = scales > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, scales, torch.ones_like(scales)),
                      torch.zeros_like(scales))
    clean = torch.where(ok[..., None], rows, torch.zeros_like(rows))
    scaled = torch.clamp(clean * inv[..., None], -q, q)
    if not dtype.is_floating_point:
        scaled = torch.round(scaled)
    return scaled.to(dtype), scales, ok


def quantize_rows(rows: torch.Tensor, *, dtype: torch.dtype):
    """(…, d) rows -> ((…, d) quantized payload, (…,) fp32 scales)."""
    payload, scales, _ = _quantize(rows, dtype)
    return payload, scales


def quantize_rows_checked(rows: torch.Tensor, *, dtype: torch.dtype):
    """``quantize_rows`` + the count (0-d int32 tensor) of non-finite rows
    that were zeroed."""
    payload, scales, ok = _quantize(rows, dtype)
    return payload, scales, (~ok).sum(dtype=torch.int32)


def dequantize_rows(payload: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """payload (…, d) × scales (…,) -> fp32."""
    return payload.float() * scales[..., None].float()


def _range(dtype: torch.dtype) -> Optional[tuple[float, float]]:
    """Representable [lo, hi] of ``dtype``, or None when it covers fp32."""
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        return float(info.min), float(info.max)
    info = torch.finfo(dtype)
    if float(info.max) >= float(torch.finfo(torch.float32).max):
        return None
    return float(info.min), float(info.max)


def saturate_cast(rows: torch.Tensor, *, dtype: torch.dtype):
    """Cast with a range check: values outside ``dtype``'s range are
    clipped to it and counted. Returns ``(cast_rows, n_clipped)``."""
    rng = _range(dtype)
    if rng is None:
        return rows.to(dtype), torch.zeros((), dtype=torch.int32, device=rows.device)
    lo, hi = rng
    rows = rows.float()
    n = ((rows < lo) | (rows > hi)).sum(dtype=torch.int32)
    return torch.clamp(rows, lo, hi).to(dtype), n
