"""Build and load the port's CUDA kernels.

Every ``kernels/*/csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into an object, all sources at once in parallel processes, and
the objects are linked into one shared library with a plain C interface,
loaded with ``ctypes``. No PyTorch header is included, so a build takes
seconds. The library lands in ``build/repro_torch_kernels/<key>/`` at the
repository root, keyed by a hash of the sources and flags, and is built at
the first CUDA call of any kernel wrapper (never at import).

Numerics: no ``--use_fast_math``; the kernels hash in IEEE fp32.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import torch

KERNELS_DIR = Path(__file__).resolve().parent
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch_kernels"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
INCLUDE_DIR = KERNELS_DIR / "sdim_bucket" / "csrc"   # sdim_common.cuh

# storage dtype codes shared with csrc/sdim_common.cuh (enum DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.float8_e4m3fn: 3}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argtypes (every pointer and the stream as c_void_p)
SIGNATURES = {
    "sdim_bse_encode": [_P, _I, _P, _P, _P] + [_I] * 8 + [_P],
    "sdim_update": [_P, _P, _P, _I, _P, _P, _P] + [_I] * 8 + [_P],
    "sdim_query": [_P, _I, _P, _P, _P] + [_I] * 10 + [_P],
    "sdim_fused_serve": [_P, _I, _P, _P, _P, _P, _P, _P] + [_I] * 10 + [_P],
    "sdim_bse_serve": [_P, _P, _I, _P, _P, _P, _P] + [_I] * 8 + [_P],
    "sdim_target_attention": [_P, _P, _I, _P, _P] + [_I] * 4 + [_F, _I, _P],
    "sdim_bse_encode_backward": [_P, _P, _I, _P, _P, _P] + [_I] * 9 + [_P],
    "sdim_query_backward": [_P, _P, _P, _P, _P] + [_I] * 8 + [_P],
    "sdim_target_attention_backward": [_P, _P, _P, _I, _P, _P, _P, _P, _P] + [_I] * 4
                                      + [_F, _I, _I, _P],
    # cluster capacity queries: clusters of a launch the device holds at once
    "sdim_target_attention_backward_clusters": [_I] * 5,
    "sdim_bse_encode_backward_clusters": [_I] * 5,
    # CTA capacity queries: CTAs of a launch one SM holds at once
    "sdim_bse_encode_backward_large_tau_ctas": [_I] * 6,
    "sdim_query_wide_ctas": [_I] * 7,
    "sdim_fused_serve_wide_ctas": [_I] * 7,
    # the device's opt-in shared memory a CTA (bytes)
    "sdim_smem_optin": [],
}

_lib: Optional[ctypes.CDLL] = None
_load_lock = threading.Lock()


def sources() -> list[Path]:
    return sorted(KERNELS_DIR.glob("*/csrc/*.cu"))


def _key(nvcc: str, flags) -> str:
    h = hashlib.sha256()
    for f in sorted(KERNELS_DIR.glob("*/csrc/*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(flags).encode())
    h.update(nvcc.encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "port's CUDA kernels cannot be built on this host")
    return nvcc


def build(defines: tuple = ()) -> Path:
    """Compile every kernel source (one ``nvcc`` per source, all started
    together) and link them into one ``.so``; returns its path. A library
    already built from the same sources and flags is reused. ``defines``
    (``-D`` flags) build a variant beside the port's library, e.g. the phase
    clocks of ``phase_clocks.py``."""
    nvcc = _nvcc()
    flags = (*NVCC_FLAGS, *defines)
    out_dir = BUILD_DIR / _key(nvcc, flags)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *flags, "-I", str(INCLUDE_DIR), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, obj, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {src.relative_to(REPO_ROOT)}\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        (out_dir / "nvcc.log").write_text("\n".join(logs))
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib), *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)
    return lib


def bind(path: Path) -> ctypes.CDLL:
    """Load a kernel library and declare its C entry points."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process.
    A lock serializes the first call, so a writer thread and a request
    thread launching at once start one build, not two."""
    global _lib
    if _lib is None:
        with _load_lock:
            if _lib is None:
                _lib = bind(build())
    return _lib


def loaded() -> bool:
    """Whether this process has built or loaded the kernel library yet."""
    return _lib is not None


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """The one CUDA device all of ``tensors`` lie on; raises otherwise.
    Compares device indices (``get_device``, -1 off CUDA), which costs less
    host time than building ``torch.device`` objects on every launch."""
    index = tensors[0].get_device()
    if index < 0 or any(t.get_device() != index for t in tensors):
        devs = sorted({str(t.device) for t in tensors})
        raise ValueError(f"{name}: the kernel takes tensors on one CUDA "
                         f"device, got {devs}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
    return tensors[0].device


def require_aligned(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless each tensor starts on a 16-byte boundary (the kernels
    that stage rows with cp.async copy 16 bytes at a time)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel takes tensors that start on a "
                             f"16-byte boundary (clone the view)")


def needs_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether autograd would record a call on ``tensors``: grad mode is on
    and one of them requires grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in tensors)


def refuse_grad(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise where autograd would record a call of a kernel that has no
    backward (the serving kernels): its output would be cut off from the
    graph without a word."""
    if needs_grad(*tensors):
        raise RuntimeError(f"{name}: the kernel has no backward; call it under "
                           f"torch.no_grad() or on tensors that do not require grad")


def dtype_code(name: str, t: torch.Tensor, allowed) -> int:
    if t.dtype not in allowed:
        raise TypeError(f"{name}: dtype {t.dtype} not taken by the kernel "
                        f"(takes {[str(a) for a in allowed]})")
    return DTYPE_CODES[t.dtype]


_SM_COUNT: dict = {}


def sm_count(device: torch.device) -> int:
    """The number of SMs of ``device``, asked once per device (the wrappers
    size their grids to fill one wave)."""
    n = _SM_COUNT.get(device.index)
    if n is None:
        n = _SM_COUNT[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


_CLUSTERS: dict = {}


def clusters(entry: str, device: torch.device, *args: int) -> int:
    """The clusters of a kernel's launch that ``device`` holds at once (or,
    for a ``*_ctas`` entry, the CTAs one SM holds), by the kernel's own
    capacity query, the C entry point ``entry`` (its launch's shared memory
    through cudaOccupancyMaxActiveClusters or
    cudaOccupancyMaxActiveBlocksPerMultiprocessor; 0 where a CTA does not
    fit), asked once per library, device and arguments (another build of
    the kernel, as ``phase_clocks.py``'s, may fit fewer)."""
    lib = load()
    key = (entry, id(lib), device.index) + args
    n = _CLUSTERS.get(key)
    if n is None:
        with on_device(device):
            n = getattr(lib, entry)(*args)
        if n < 0:
            raise ValueError(f"{entry}: arguments {args} not taken by the kernel")
        _CLUSTERS[key] = n
    return n


def smem_optin(device: torch.device) -> int:
    """The shared memory a CTA of ``device`` may opt in to (bytes; 232,448
    on the H100), asked once per device."""
    return clusters("sdim_smem_optin", device)


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream(device: torch.device) -> int:
    """The current stream of ``device`` as the C entry points take it, read
    without building a ``torch.cuda.Stream`` object: that costs some
    microseconds a call, which an event-timed launch of a short kernel pays
    in full."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def on_device(device: torch.device):
    """Make ``device`` current for a launch: ``torch.cuda.device(device)``,
    or nothing where it is current already (entering the guard costs some
    microseconds)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
