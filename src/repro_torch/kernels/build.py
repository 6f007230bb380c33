"""Build and load the port's CUDA kernels (route b: nvcc + ctypes).

Every ``csrc/*.cu`` is compiled for ``sm_90a`` by its own ``nvcc -c``
(all started together), then linked into ONE shared library with a plain
C interface, loaded with :mod:`ctypes`.  The library lands in
``build/repro_torch_kernels/`` at the repository root (listed in
``.gitignore``), named by a hash of the sources, and is built at first use
— never at import, so the CPU tests import every module without ``nvcc``.

Entries return ``cudaGetLastError()``; :func:`check` raises on non-zero.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH = "arch=compute_90a,code=sm_90a"

# dtype codes of csrc/common.cuh (LeoamDType)
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SIGNATURES = {
    "leoam_kv_dequant_scatter": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 _LL, _I, _P],
    "leoam_chunk_bounds": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _LL, _LL, _LL, _P],
    "leoam_chunk_bounds_latent": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _LL, _LL, _P],
    "leoam_sparse_decode_latent": [_P, _P, _LL, _P, _P, _I, _P, _P, _I, _I,
                                   _I, _I, _I, _P, _P, _I, _P],
    "leoam_sparse_decode": [_P, _P, _P, _LL, _P, _P, _I, _I, _I, _LL, _P,
                            _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                            _P, _P, _P, _P, _P, _I, _I, _P],
    "leoam_pq_assign": [_P, _P, _P, _I, _I, _I, _I, _P, _P],
    "leoam_pq_update": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}

# entries that return a size (f32 elements of a kernel's scratch)
_SIZES = {"leoam_sparse_decode_latent_scratch": [_I, _I, _I, _I, _I]}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build repro_torch's kernels")
    return found


def sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libleoam_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every source in parallel and link the shared library (a
    no-op when the hashed library exists)."""
    so = library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    tmp = BUILD_DIR / f"tmp-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    flags = ["-gencode", ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    objs, procs = [], []
    for src in sources():
        obj = tmp / (src.stem + ".o")
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *flags, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    part = tmp / so.name
    res = subprocess.run([nvcc, "-gencode", ARCH, "-shared", "-o", str(part),
                          *map(str, objs)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
    os.replace(part, so)
    shutil.rmtree(tmp, ignore_errors=True)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            for name, args in _SIZES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_longlong
            lib.leoam_error_string.argtypes = [ctypes.c_int]
            lib.leoam_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    """Raise when a kernel entry reported a CUDA error."""
    if rc != 0:
        msg = library().leoam_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a C pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, for a kernel's vector loads
    (a copy only when it is neither)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def use_kernel(impl: Optional[str], t: torch.Tensor) -> bool:
    """Dispatch by device: a CUDA tensor launches the kernel, a CPU tensor
    takes the plain version.  ``impl="ref"`` asks for the plain version
    on any device (an explicit request, never a fallback)."""
    if impl == "ref":
        return False
    if impl is not None:
        raise ValueError(f"impl must be None or 'ref', got {impl!r}")
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for a tensor on {t.device}")
