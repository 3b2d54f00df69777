"""Device resolution for the port's entry points.

Entry points take ``device=`` and default to ``"cuda"``. Without a card
they raise unless the caller asked for the CPU: the port never moves to the
CPU silently. Under a ``FakeTensorMode`` (the dry-run's tensors, which
have a device and no storage) a CUDA device resolves without a card: such
tensors allocate nothing and launch nothing. On the card, TF32 is switched
off for matrix products and convolutions, because the reference's
residual arm and oracles contract in full f32 and TF32 would break parity
with them.

``gc_paused`` keeps Python's cyclic collector from running inside a CUDA
graph capture.
"""
from __future__ import annotations

import gc
from contextlib import contextmanager

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if _fake_mode_active():
            return dev
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def _fake_mode_active() -> bool:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    return any(isinstance(m, FakeTensorMode)
               for m in _get_current_dispatch_mode_stack())


@contextmanager
def gc_paused():
    """Python's cyclic garbage collector paused for the scope, as it was
    before after. Wrap every CUDA graph capture in it: an engine that died
    in a reference cycle keeps its graphs until the collector runs, and a
    graph destroyed while a stream captures invalidates the capture
    (``cudaErrorStreamCaptureInvalidated``). PyTorch's ``torch.cuda.graph``
    no longer collects before it begins."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()
