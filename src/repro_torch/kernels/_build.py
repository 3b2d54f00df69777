"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with ``nvcc``
for ``sm_90a`` into its own shared library under ``build/`` at the root of
the checkout, on first use, and loaded with ``ctypes``. The library's file
name carries a hash of its source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source or header is rebuilt and a stale library is
never loaded. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

from repro_torch.core.qformats import QBLOCK

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: each kernel: its source ``csrc/<source>.cu``, which exports one C
#: function of the kernel's name, and that function's argument types (every
#: one returns an int CUDA error code)
KERNELS: Dict[str, Tuple[str, list]] = {
    # (x, x_bf16, ldx, qs, ldq, scales, lds, out, ldo, m, n, k, then the
    # tile: rows, warps, split; stream)
    "q8_matvec": ("q8_matvec",
                  [_P, _I, _L, _P, _L, _P, _L, _P, _L, _I, _I, _I,
                   _I, _I, _I, _P]),
    # (... as q8_matvec, then the tile: block_n, stages; stream)
    "q8_matmul": ("q8_matmul",
                  [_P, _I, _L, _P, _L, _P, _L, _P, _L, _I, _I, _I,
                   _I, _I, _P]),
    # (x, x_bf16, ldx, w, w_bf16, ldw, out, ldo, m, n, k, then the tile:
    # rows, warps, split at M <= 16, stages at M > 16; stream)
    "bf16_matmul": ("bf16_matmul",
                    [_P, _I, _L, _P, _I, _L, _P, _L, _I, _I, _I,
                     _I, _I, _I, _I, _P]),
    # (q, k, v, bf16, q_sbh, q_ss, k_sbh, k_ss, v_sbh, v_ss, out, lse (or
    #  null), bh, sq, sk, d, causal, stream)
    "flash_attention_fwd": ("flash_attention",
                            [_P, _P, _P, _I, _L, _L, _L, _L, _L, _L, _P, _P,
                             _I, _I, _I, _I, _I, _P]),
    # (q, k, v, out, dout, lse, delta scratch, dq, dk, dv, bf16, the (BH,
    #  S) strides of q, k, v, out and dout, lse's BH stride, bh, sq, sk, d,
    #  causal, stream)
    "flash_attention_bwd": ("flash_attention_bwd",
                            [_P] * 10 + [_I] + [_L] * 11 + [_I] * 5
                            + [_P]),
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _source(name: str) -> Path:
    return CSRC / f"{KERNELS[name][0]}.cu"


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, every shared
    header in ``csrc/`` and the flags: an edited header rebuilds too."""
    src = _source(name)
    digest = hashlib.sha1(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"{src.stem}-{digest.hexdigest()[:12]}.so"


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
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_source(name))]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, target)
    logs = {}
    failed = []
    for name, (proc, tmp, target) in jobs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {_source(name).name}:\n{out}")
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
        fn.argtypes = KERNELS[name][1]
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


def fake_q8(x, qs, scales, **_):
    """A Q8_0 product's checks and its (M, N) f32 output, empty: what a
    counted call over fake tensors returns (``roofline/op_cost.priced``)."""
    check_q8_operands(x, qs, scales)
    return x.new_empty((x.shape[0], qs.shape[0]), dtype=torch.float32)


def check_dense_operands(x: torch.Tensor, w: torch.Tensor) -> None:
    """Shapes, types and layouts ``bf16_matmul`` takes: x (M, K) and W
    (N, K), each in f32 or bf16, with unit stride along K (rows may be
    strided), on one device."""
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError("bf16_matmul takes 2-D x and w")
    if x.shape[1] != w.shape[1]:
        raise ValueError(f"contraction mismatch {x.shape[1]} vs {w.shape[1]}")
    if x.shape[1] == 0:
        raise ValueError("bf16_matmul needs K >= 1")
    for name, t in (("x", x), ("w", w)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name} must be float32 or bfloat16, not "
                            f"{t.dtype}")
    if x.device != w.device:
        raise ValueError("x and w must lie on one device")
    if x.stride(-1) != 1 or w.stride(-1) != 1:
        raise ValueError("the last dim of x and w must be contiguous")


def check_attention_operands(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor) -> None:
    """Shapes, types and layouts ``flash_attention_fwd`` takes: q (BH, Sq,
    D), k and v (BH, Sk, D), all f32 or all bf16, with unit stride along D
    (the BH and S strides are free), on one device."""
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise ValueError("flash attention takes 3-D (BH, S, D) q, k and v")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or \
            k.shape[2] != q.shape[2]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} disagree")
    if q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError("flash attention needs Sq >= 1 and Sk >= 1")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must all be float32 or all bfloat16")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the last dim of q, k and v must be contiguous")


def require_cuda(name: str, device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"{name}: operands on {device}, expected a CUDA "
                         "device")


def call(name: str, device: torch.device, *args) -> None:
    """Launch kernel ``name`` on ``device``'s current stream with ``args``
    (its C arguments before the stream); raises if the launch was
    refused."""
    require_cuda(name, device)
    fn = getattr(load(name), name)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")


def launch_q8(name: str, x: torch.Tensor, qs: torch.Tensor,
              scales: torch.Tensor, tile: Tuple[int, ...]) -> torch.Tensor:
    """Launch Q8_0 kernel ``name`` on CUDA operands (already checked) with
    the C tile arguments ``tile`` (zeros: the kernel's own choice).
    Returns the (M, N) f32 output."""
    require_cuda(name, x.device)
    m, k = x.shape
    n = qs.shape[0]
    if qs.data_ptr() % 16 or qs.stride(0) % 16:
        raise ValueError(f"{name}: qs rows must be 16-byte aligned")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    call(name, x.device,
         x.data_ptr(), int(x.dtype == torch.bfloat16), x.stride(0),
         qs.data_ptr(), qs.stride(0), scales.data_ptr(), scales.stride(0),
         out.data_ptr(), out.stride(0), m, n, k, *tile)
    return out
