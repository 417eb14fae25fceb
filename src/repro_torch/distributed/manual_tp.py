"""The Megatron tensor-parallel gated FFN with explicit collectives.

Counterpart of ``repro/distributed/manual_tp.py::manual_tp_gated_ffn``,
the reference's ``shard_map`` body run over ``MeshCtx`` blocks in one
process. For each (data, model) block of the mesh:

    x (B/dp, T/tp, d)  --all-gather over model, bf16-->  (B/dp, T, d)
    h = act(x @ wi_gate[:, f block]) * (x @ wi_up[:, f block])   (B/dp, T, f/tp)
    y_part = h @ wo[f block, :]                                  (B/dp, T, d)
    --sum over the model blocks, split over T-->                 (B/dp, T/tp, d)

The all-gather is the model blocks of x concatenated back over T and cast
to the compute dtype; the weights' FSDP gather over the data axes has
nothing to do, since the port holds each weight whole; ``wi_gate``/``wi_up``
are read as (d, f/tp) column blocks and ``wo`` as (f/tp, d) row blocks of
the reference's layout, from the port's transposed ``nn.Linear`` weights,
each cast to the compute dtype on its block's device; the reduce-scatter
sums the partials in block order on the first block's device
(``mesh_ctx.psum``), in the compute dtype, and splits the sum over T. The
result is cast back to x's dtype. So it is the reference's result, not the
one-device FFN's: products and sums in bf16.

Differentiable through plain torch ops (``cat``, ``split``, casts and
matmuls), so autograd and remat run it as any other block. Where B, T, the
FFN width or d do not divide by their block counts it raises, as
``shard_map`` does; it never falls back to the dense FFN.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.mesh_ctx import MeshCtx, block_size, psum
from repro_torch.nn.layers import ACTIVATIONS


def manual_tp_gated_ffn(x: torch.Tensor, ffn, ctx: MeshCtx, activation: str = "silu",
                        compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x (B, T, d) through ``ffn`` (a bias-free ``nn.layers.GatedMLP``)
    as the (data, model) blocks of ``ctx`` -> (B, T, d) in x's dtype."""
    if ffn.wi_gate.bias is not None:
        raise ValueError("manual_tp_gated_ffn takes a bias-free FFN")
    B, T, d = x.shape
    tp, dp = ctx.ep, ctx.dp
    Bl = block_size(B, dp, f"the batch over {dp} data blocks: B")
    Tl = block_size(T, tp, f"the sequence over {tp} model blocks: T")
    f = ffn.wi_gate.weight.shape[0]
    fl = block_size(f, tp, f"the FFN width over {tp} model blocks: d_ff")
    block_size(d, dp, f"the weights' model width over {dp} data blocks (their FSDP split): d")
    act = ACTIVATIONS[activation]
    devices = ctx.axis_devices((ctx.model_axis,))
    # block m's weights in the reference's layout, transposed views of the
    # port's (out, in): wi_gate/wi_up (d, f/tp), wo (f/tp, d)
    weights = []
    for m, dev in enumerate(devices):
        cols = slice(m * fl, (m + 1) * fl)
        weights.append(tuple(w.to(dev, compute_dtype) for w in (
            ffn.wi_gate.weight[cols].t(), ffn.wi_up.weight[cols].t(), ffn.wo.weight[:, cols].t())))
    out = []
    for g in range(dp):
        xb = x[g * Bl:(g + 1) * Bl]
        xg = torch.cat([xb[:, m * Tl:(m + 1) * Tl] for m in range(tp)], dim=1).to(compute_dtype)
        parts = []
        for dev, (wg, wu, wo) in zip(devices, weights):
            xm = xg.to(dev)
            parts.append((act(xm @ wg) * (xm @ wu)) @ wo)
        y = psum(parts)
        out.append(torch.cat([blk.to(x.device) for blk in torch.split(y, Tl, dim=1)], dim=1))
    return torch.cat(out).to(x.dtype)
