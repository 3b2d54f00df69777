"""The backend registry and its resolver.

``resolve(request)`` is the one call that selects a kernel implementation.
Precedence for a *main* segment:

  1. a forced backend — the ``force("name")`` context;
  2. a pinned backend — a plan entry's ``backend``;
  3. capability order: the first registered backend whose ``auto(request)``
     volunteers (hopper for every main segment, Q8_0 or dense;
     host_residual for residual segments).

Residual segments skip 1-2: the host residual arm is part of the paper's
mixed-execution semantics (f32 on the host arm), not a choice to redirect.
A forced or pinned backend that cannot support the request falls through
to capability order. Only ``hopper`` supports a main segment, so no force
or pin can send one to a plain version on the card.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from repro_torch.backends.base import MAIN, Backend, KernelRequest


class BackendRegistry:
    """Ordered backend collection + the capability resolver."""

    def __init__(self) -> None:
        self._backends: Dict[str, Backend] = {}
        self._order: List[str] = []
        self._forced: Optional[str] = None

    def register(self, backend: Backend) -> Backend:
        """Add a backend; registration order is resolution priority."""
        if backend.name not in self._backends:
            self._order.append(backend.name)
        self._backends[backend.name] = backend
        return backend

    def get(self, name: str) -> Backend:
        try:
            return self._backends[name]
        except KeyError:
            raise KeyError(
                f"unknown backend {name!r}; registered: {self.names()}"
            ) from None

    def names(self) -> Tuple[str, ...]:
        return tuple(self._order)

    @contextmanager
    def force(self, name: str):
        """Force main-segment resolution to ``name`` while active."""
        self.get(name)                       # fail fast on typos
        prev, self._forced = self._forced, name
        try:
            yield self
        finally:
            self._forced = prev

    def resolve(self, req: KernelRequest,
                pin: Optional[str] = None) -> Backend:
        """The backend that will run ``req`` (see the module docstring)."""
        if req.segment == MAIN:
            for name in (self._forced, pin):
                if name:
                    b = self.get(name)
                    if b.supports(req):
                        return b
        for name in self._order:
            b = self._backends[name]
            if b.auto(req):
                return b
        raise LookupError(f"no registered backend volunteers for {req}")


#: the process-wide registry; populated with the built-in backends by
#: ``repro_torch.backends.__init__``
REGISTRY = BackendRegistry()
