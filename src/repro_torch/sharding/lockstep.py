"""Data shards run in lockstep: the port's all-gather inside one eager
program.

One controller drives every data shard of a step, one after another
(``train/step.py``). Where a shard needs a value that every shard makes
partway through its program (the expert choices of a MoE layer whose
capacity claim spans the shards, ``models/moe.py``), the shards cannot
run one after another. ``run(fns)`` runs ``fns[i]`` as data shard ``i``
in a thread of its own, one thread at a time, in shard order: shard i
runs until it calls ``exchange(value)`` (read through
``sharding.ctx.current_lockstep()``), then shard i + 1 runs to the same
point; when the last shard has given its value, every shard's call
returns the list of all of them, in shard order, and shard 0 runs on to
its next exchange. Shards that never exchange run one after another,
in shard order. The order of every operation is fixed, so a run is
deterministic, and nothing two shards make is touched by both.

Each thread starts in the caller's context: ``sharding.ctx``'s scopes,
PyTorch's grad mode, and, where CUDA is in use, the current device and
each device's current stream (a new thread would launch on the default
streams). Autograd graphs built in the threads are
differentiated by the caller as usual. Every shard must call ``exchange``
as many times as the others (the same layers); an exception in one
shard stops the others and is raised by ``run``.
"""
from __future__ import annotations

import threading
from contextlib import ExitStack, contextmanager
from typing import Any, Callable, List, Sequence

import torch

from repro_torch.sharding import ctx


class _Stopped(Exception):
    """Another shard failed: this one stops at its next exchange."""


class _Baton:
    def __init__(self, n: int):
        self.n = n
        self.cv = threading.Condition()
        self.turn = 0
        self.vals: List[Any] = [None] * n
        self.out: List[Any] = []
        self.failed = False

    def _wait(self, i: int) -> None:
        self.cv.wait_for(lambda: self.turn == i or self.failed)
        if self.failed:
            raise _Stopped

    def start(self, i: int) -> None:
        with self.cv:
            self._wait(i)

    def exchange(self, i: int, value) -> list:
        with self.cv:
            self.vals[i] = value
            if i == self.n - 1:
                self.out = list(self.vals)
            self.turn = (i + 1) % self.n
            self.cv.notify_all()
            self._wait(i)
            return self.out

    def finish(self, i: int) -> None:
        with self.cv:
            self.turn = i + 1
            self.cv.notify_all()

    def fail(self) -> None:
        with self.cv:
            self.failed = True
            self.cv.notify_all()


def _cuda_state():
    """The caller's current CUDA device and every device's current stream
    (None where CUDA is not initialized)."""
    if not torch.cuda.is_initialized():
        return None
    return torch.cuda.current_device(), [
        torch.cuda.current_stream(d) for d in range(torch.cuda.device_count())]


@contextmanager
def _cuda_restored(state):
    with ExitStack() as stack:
        if state is not None:
            dev, streams = state
            for s in streams:
                stack.enter_context(torch.cuda.stream(s))
            stack.enter_context(torch.cuda.device(dev))
        yield


def run(fns: Sequence[Callable[[], Any]]) -> List[Any]:
    """``[fn() for fn in fns]``, each ``fns[i]`` run as data shard i of a
    lockstep step (the module's docstring)."""
    n = len(fns)
    baton = _Baton(n)
    snap = ctx.snapshot()
    grad = torch.is_grad_enabled()
    cuda = _cuda_state()
    results: List[Any] = [None] * n
    errors: List[BaseException] = []

    def body(i: int) -> None:
        try:
            baton.start(i)
            with ctx.restored(snap), torch.set_grad_enabled(grad), \
                    _cuda_restored(cuda), \
                    ctx.lockstep(i, lambda v: baton.exchange(i, v)):
                results[i] = fns[i]()
            baton.finish(i)
        except _Stopped:
            pass
        except BaseException as e:        # handed to the caller below
            errors.append(e)
            baton.fail()

    threads = [threading.Thread(target=body, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results
