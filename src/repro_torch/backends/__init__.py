"""Pluggable execution backends of the port.

A ``KernelRequest`` describes one segment of one linear statically, a
``Backend`` answers it, and ``REGISTRY.resolve`` selects who runs it.
Built-ins, in capability-resolution order:

  hopper         the hand-written CUDA kernels for every main segment
                 (Q8_0 and dense)
  host_residual  the f32 arm for unaligned tails
"""
from repro_torch.backends.base import (  # noqa: F401
    MAIN, RESIDUAL, Backend, KernelRequest, kernel_for, padded_m)
from repro_torch.backends.host_residual import HostResidualBackend
from repro_torch.backends.hopper import HopperBackend
from repro_torch.backends.registry import REGISTRY, BackendRegistry  # noqa: F401

# registration order is capability-resolution priority
REGISTRY.register(HopperBackend())
REGISTRY.register(HostResidualBackend())
