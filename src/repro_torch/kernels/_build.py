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

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
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
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point -> argtypes (every pointer and the stream as c_void_p)
SIGNATURES = {
    "sdim_bse_encode": [_P, _I, _P, _P, _P] + [_I] * 7 + [_P],
    "sdim_update": [_P, _P, _P, _I, _P, _P] + [_I] * 7 + [_P],
    "sdim_query": [_P, _I, _P, _P, _P] + [_I] * 8 + [_P],
    "sdim_fused_serve": [_P, _I, _P, _P, _P, _P, _P, _P] + [_I] * 8 + [_P],
}

_lib: Optional[ctypes.CDLL] = None


def sources() -> list[Path]:
    return sorted(KERNELS_DIR.glob("*/csrc/*.cu"))


def _key(nvcc: str) -> str:
    h = hashlib.sha256()
    for f in sorted(KERNELS_DIR.glob("*/csrc/*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc.encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "port's CUDA kernels cannot be built on this host")
    return nvcc


def build() -> Path:
    """Compile every kernel source (one ``nvcc`` per source, all started
    together) and link them into one ``.so``; returns its path. A library
    already built from the same sources and flags is reused."""
    nvcc = _nvcc()
    out_dir = BUILD_DIR / _key(nvcc)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-c", str(src),
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


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """The one CUDA device all of ``tensors`` lie on; raises otherwise."""
    devs = {t.device for t in tensors}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{name}: the kernel takes tensors on one CUDA "
                         f"device, got {sorted(map(str, devs))}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
    return next(iter(devs))


def dtype_code(name: str, t: torch.Tensor, allowed) -> int:
    if t.dtype not in allowed:
        raise TypeError(f"{name}: dtype {t.dtype} not taken by the kernel "
                        f"(takes {[str(a) for a in allowed]})")
    return DTYPE_CODES[t.dtype]


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
