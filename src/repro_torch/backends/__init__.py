"""Pluggable execution backends of the port.

A ``KernelRequest`` describes one segment of one linear statically, a
``Backend`` answers it, and ``REGISTRY.resolve`` selects who runs it.
Built-ins, in capability-resolution order:

  hopper         the hand-written CUDA kernels for Q8_0 main segments
  host_residual  the f32 arm for unaligned tails
  torch_ref      the dense ``kernels/ref.py`` oracle for dense main segments
"""
from repro_torch.backends.base import (  # noqa: F401
    MAIN, RESIDUAL, Backend, KernelRequest, kernel_for, padded_m)
from repro_torch.backends.host_residual import HostResidualBackend
from repro_torch.backends.hopper import HopperBackend
from repro_torch.backends.registry import REGISTRY, BackendRegistry  # noqa: F401
from repro_torch.backends.torch_ref import TorchRefBackend

# registration order is capability-resolution priority
REGISTRY.register(HopperBackend())
REGISTRY.register(HostResidualBackend())
REGISTRY.register(TorchRefBackend())
