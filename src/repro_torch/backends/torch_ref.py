"""The reference backend: ``kernels/ref.py``'s dense oracle in plain
PyTorch — the role of the reference's ``xla_ref`` backend.

It runs the dense (``bf16``) main segments, whose Hopper kernel comes with
a later slice. It takes no Q8_0 segment, even when forced or pinned: a
Q8_0 main segment runs on the Hopper kernels (their plain versions on CPU
tensors), whatever its plan entry's ``offload`` flag says.
"""
from __future__ import annotations

from repro_torch.backends.base import KernelRequest
from repro_torch.kernels import ref


class TorchRefBackend:
    """Dense reference semantics on whatever device holds the operands."""

    name = "torch_ref"

    def supports(self, req: KernelRequest) -> bool:
        return req.dtype != "q8_0"

    def auto(self, req: KernelRequest) -> bool:
        return self.supports(req)

    def build(self, req: KernelRequest):
        return ref.matmul_bf16_ref
