"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with ``nvcc``
for ``sm_90a`` into its own shared library under ``build/`` at the root of
the checkout, on first use, and loaded with ``ctypes``. The library's file
name carries a hash of its source and flags, so an edited source is rebuilt
and a stale library is never loaded. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

from repro_torch.core.qformats import QBLOCK

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# every kernel of the port exports one C function of this signature:
#   int fn(const void* x, int x_bf16, long long ldx,
#          const void* qs, long long ldq, const void* scales, long long lds,
#          void* out, long long ldo, int m, int n, int k, void* stream)
_Q8_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD / f"{name}-{digest.hexdigest()[:12]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named kernels that are not built yet, one ``nvcc`` per
    source, all started together. Returns each new build's compiler output
    (the ``-Xptxas -v`` register and shared-memory report); raises on the
    first failed build."""
    BUILD.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, target)
    logs = {}
    failed = []
    for name, (proc, tmp, target) in jobs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{out}")
        else:
            os.replace(tmp, target)      # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel's loaded library, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        fn = getattr(lib, name)
        fn.argtypes = _Q8_ARGTYPES
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check_q8_operands(x: torch.Tensor, qs: torch.Tensor,
                      scales: torch.Tensor) -> None:
    """Shapes, types and layouts the Q8_0 kernels take: x (M, K) in f32 or
    bf16, qs (N, K) int8, scales (N, K/32) f32, each with unit stride along
    its last dim (rows may be strided), all on one device."""
    if x.ndim != 2 or qs.ndim != 2 or scales.ndim != 2:
        raise ValueError("q8 kernels take 2-D x, qs and scales")
    (m, k), (n, k2) = x.shape, qs.shape
    if k != k2:
        raise ValueError(f"contraction mismatch {k} vs {k2}")
    if k % QBLOCK or k == 0:
        raise ValueError(f"K={k} must be a positive multiple of {QBLOCK}")
    if scales.shape != (n, k // QBLOCK):
        raise ValueError(f"scales {tuple(scales.shape)} != {(n, k // QBLOCK)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, not {x.dtype}")
    if qs.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError("qs must be int8 and scales float32")
    if not (x.device == qs.device == scales.device):
        raise ValueError("x, qs and scales must lie on one device")
    if x.stride(-1) != 1 or qs.stride(-1) != 1 or scales.stride(-1) != 1:
        raise ValueError("the last dim of x, qs and scales must be contiguous")


def launch(name: str, x: torch.Tensor, qs: torch.Tensor,
           scales: torch.Tensor) -> torch.Tensor:
    """Launch kernel ``name`` on CUDA operands (already checked) on the
    current stream. Returns the (M, N) f32 output; raises if the launch
    was refused."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: operands on {x.device}, expected a CUDA "
                         "device")
    m, k = x.shape
    n = qs.shape[0]
    if qs.data_ptr() % 16 or qs.stride(0) % 16:
        raise ValueError(f"{name}: qs rows must be 16-byte aligned")
    lib = load(name)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = getattr(lib, name)(
            x.data_ptr(), int(x.dtype == torch.bfloat16), x.stride(0),
            qs.data_ptr(), qs.stride(0), scales.data_ptr(), scales.stride(0),
            out.data_ptr(), out.stride(0), m, n, k, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")
    return out
