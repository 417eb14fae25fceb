"""Shared set-up of the port's serving-runtime parity tests
(``test_torch_runtime.py``, ``test_torch_tiered_store.py``,
``test_torch_ingest.py``): a small SDIM engine in both packages over the
JAX package's hash family R, and a behavior table, indexed by (item, cat),
whose every row clears the hash margin of R (``kernels/screen.py``), so the
two packages agree on every signature bit.
"""
import functools

import jax.numpy as jnp
import numpy as np
import torch

from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.engine import SDIMEngine as JSDIMEngine
from repro.serve.bse_server import BSEServer as JBSEServer
from repro_torch.core.engine import EngineConfig, SDIMEngine
from repro_torch.kernels.screen import screened_normal
from repro_torch.serve.bse_server import BSEServer

D, M, TAU = 16, 12, 2
N_ITEMS, N_CATS = 48, 8
DTYPES = ["fp32", "bf16", "int8", "fp8"]
STEP = {"int8": 1 / 127, "fp8": 32 / 448}   # widest quantization step / row max


@functools.lru_cache(maxsize=None)
def jax_engine():
    return JSDIMEngine(JEngineConfig(m=M, tau=TAU, d=D, backend="xla"))


def port_engine():
    return SDIMEngine(EngineConfig(m=M, tau=TAU, d=D),
                      R=torch.as_tensor(np.array(jax_engine().R)), device="cpu")


@functools.lru_cache(maxsize=None)
def behaviors() -> np.ndarray:
    rng = np.random.default_rng(11)
    return screened_normal(rng, (N_ITEMS, N_CATS, D), np.asarray(jax_engine().R))


def _rows(items, cats):
    return behaviors()[np.asarray(items) % N_ITEMS, np.asarray(cats) % N_CATS]


def jax_embed(params, items, cats):
    return jnp.asarray(_rows(items, cats))


def port_embed(params, items, cats):
    return torch.as_tensor(_rows(items, cats))


def pair(**kw):
    """(JAX BSEServer, port BSEServer) on the CPU with an fp32 wire and the
    same constructor arguments."""
    return (JBSEServer(jax_embed, None, jax_engine(), wire_dtype=jnp.float32, **kw),
            BSEServer(port_embed, None, port_engine(), wire_dtype=torch.float32,
                      device="cpu", **kw))


def histories(rng, n, L=10):
    items = rng.integers(0, N_ITEMS, (n, L)).astype(np.int32)
    cats = rng.integers(0, N_CATS, (n, L)).astype(np.int32)
    masks = (rng.random((n, L)) > 0.25).astype(np.float32)
    return items, cats, masks


def events(rng, users, E=None):
    shape = (len(users),) if E is None else (len(users), E)
    return (rng.integers(0, N_ITEMS, shape).astype(np.int32),
            rng.integers(0, N_CATS, shape).astype(np.int32))


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def assert_rows_close(ours, ref, dtype: str):
    """Port rows against JAX rows in fp32: atol 1e-5 for fp32 stores; the
    reference's bf16 tolerance for bf16 (the JAX package keeps a folded bf16
    store in fp32 until it demotes it, the port rounds every write); one
    quantization step of the row's largest value for int8/fp8 (the same
    fp32 sums to rounding may round to neighbouring levels)."""
    a, b = as_np(ours), as_np(ref)
    assert a.shape == b.shape, (a.shape, b.shape)
    if dtype == "fp32":
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
    elif dtype == "bf16":
        np.testing.assert_allclose(a, b, atol=5e-2, rtol=2e-2)
    else:
        step = STEP[dtype] * np.abs(b).max(axis=-1, keepdims=True) * 1.01 + 1e-6
        assert np.all(np.abs(a - b) <= step), float(np.max(np.abs(a - b) - step))


def bits(t: torch.Tensor) -> torch.Tensor:
    """The raw bits of a stored tensor, comparable with ``torch.equal``."""
    view = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8,
            torch.float32: torch.int32}.get(t.dtype)
    return t if view is None else t.view(view)
