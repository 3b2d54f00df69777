"""Serving observability for the port: per-request lifecycle tracing,
step-clock metrics, Perfetto/Prometheus export — the counterpart of the
reference's ``repro.obs``, with the same names, records and exports.

``Telemetry`` is the one nullable handle the serving path threads
through: ``ServeEngine(telemetry=Telemetry())`` instruments the engine,
the slot, paged and speculative schedulers, the paged pool and the
launcher; ``None`` (the default) keeps every instrumentation site a single
``is not None`` test — no spans are allocated and no metrics touched.
Nothing here runs inside ``torch.cuda.graph(...)``, reads a device tensor
or synchronizes the device: every record call happens on the host between
program runs, and a span that times a step closes after the host sync the
step already makes.

The handle bundles:
  ``tracer``   obs/trace.py — lifecycle + host spans, instant events
  ``metrics``  obs/metrics.py — the serving instrument registry
and binds the engine's ``OffloadLedger`` so *ledger spans* (``span(...,
ledger=True)``, or ``ledger_open``/``ledger_close`` on the per-step hot
path) capture the exact FLOP/call delta committed while they were open.
Ledger spans are non-nesting and tightly scope every commit site
(admission prefill, batch decode step, preemption replay, speculative
round and draft admission, one-shot prefill/decode), which makes the
attribution invariant checkable:

    sum of span FLOP deltas == ledger totals delta

as an integer equality (the ledger's totals are Python ints), gated by
``chip_smoke.py``'s telemetry phase and ``tests/test_torch_obs.py``.

``activate``/``active`` expose the process-global handle that the backend
executor's dispatch counter consults (``backends/executor.py``): dispatch
resolution happens inside a program's run, where no handle is threaded
through, so a module global is the honest scope; ``ServeEngine``
activates its telemetry on construction (the last constructed wins), and
an engine without telemetry leaves the active handle as it is.
"""
from __future__ import annotations

import time
from contextlib import nullcontext
from typing import Any, Callable, Dict, Optional

from repro_torch.obs import export as export  # noqa: F401  (re-export surface)
from repro_torch.obs.metrics import (LATENCY_BUCKETS_S, Counter, Gauge, Histogram,
                               MetricsRegistry, percentile, serving_registry)
from repro_torch.obs.trace import (ENGINE_TRACK, Span, Tracer, _SpanCtx,
                             request_track)

__all__ = [
    "Telemetry", "Tracer", "Span", "MetricsRegistry", "Histogram",
    "Counter", "Gauge", "percentile", "serving_registry",
    "LATENCY_BUCKETS_S", "ENGINE_TRACK", "request_track",
    "activate", "active", "export",
]

_ACTIVE: Optional["Telemetry"] = None


def activate(tele: Optional["Telemetry"]) -> None:
    """Install ``tele`` as the process-global handle the dispatch counter
    (backends/executor.py) and eager ledger claims (core/offload.py)
    consult. ``None`` deactivates."""
    global _ACTIVE
    _ACTIVE = tele


def active() -> Optional["Telemetry"]:
    return _ACTIVE


class Telemetry:
    """The nullable observability handle.

    Every method is safe on a fully-enabled handle; disabled serving uses
    ``telemetry=None`` and never constructs one — the "no spans
    allocated" guarantee is structural (tests/test_torch_obs.py patches
    ``Telemetry``/``Tracer``/``Span`` construction to raise and drives
    full disabled drains to prove it). ``clock`` is injectable for
    deterministic tests and virtual-clock replays.
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None):
        self.tracer = Tracer(clock=clock) if tracer is None else tracer
        self.metrics = serving_registry() if metrics is None else metrics
        self._ledger = None
        self._led0 = (0, 0)
        self.claimed_flops = 0
        self.claimed_calls = 0
        self._ledger_depth = 0

    # -- ledger binding -------------------------------------------------
    def bind_ledger(self, ledger) -> None:
        """Attach the engine's ``OffloadLedger``; the consistency window
        starts here — deltas before binding belong to nobody."""
        self._ledger = ledger
        self._led0 = self._ledger_now()

    def _ledger_now(self) -> tuple:
        if self._ledger is None:
            return (0, 0)
        s = self._ledger.totals
        return (s.offloaded_flops + s.fallback_flops + s.residual_flops,
                s.offloaded_calls + s.fallback_calls)

    def ledger_delta(self) -> tuple:
        """(flops, calls) committed to the bound ledger since binding."""
        now = self._ledger_now()
        return (now[0] - self._led0[0], now[1] - self._led0[1])

    def claim_eager(self, entry, times: int = 1) -> None:
        """Claim an *eager* (unrecorded) ``OffloadEngine.linear`` account:
        those commits happen outside any span, so without this hook they
        would break the exact equality under mixed eager+planned usage. ``entry.flops`` covers the whole linear (main + residual
        when offloaded, fallback otherwise) — exactly what
        ``OffloadLedger.account`` adds to the totals per call."""
        self.claimed_flops += entry.flops * times
        self.claimed_calls += times

    def ledger_consistent(self) -> Dict[str, int]:
        """The attribution invariant, as data: ``claimed`` (summed
        over ledger spans) must equal ``ledger`` (the bound ledger's
        delta) exactly — both are integers."""
        flops, calls = self.ledger_delta()
        return {"claimed_flops": self.claimed_flops, "ledger_flops": flops,
                "claimed_calls": self.claimed_calls, "ledger_calls": calls,
                "exact": (self.claimed_flops == flops
                          and self.claimed_calls == calls)}

    # -- spans ----------------------------------------------------------
    def span(self, name: str, cat: str = "host", track: int = ENGINE_TRACK,
             rid: Optional[int] = None, ledger: bool = False,
             args: Optional[Dict[str, Any]] = None):
        """Record one host-side interval. ``ledger=True`` snapshots the
        bound ledger around the block and attaches the exact FLOP/call
        delta as span args (claimed toward the invariant); ledger
        spans must not nest — nesting would double-claim, so it raises.

        Class-based context managers, not ``@contextmanager``: the
        generator protocol costs ~3x as much as ``__enter__``/``__exit__``
        on a path that runs once per admission."""
        if ledger:
            return _LedgerSpanCtx(self, name, cat, track, rid,
                                  args if args is not None else {})
        return _SpanCtx(self.tracer, name, cat, track, rid,
                        args if args is not None else {})

    # -- hot-path ledger span (open/close pair) -------------------------
    def ledger_open(self) -> tuple:
        """Open half of a non-nesting ledger span, as a plain tuple
        handle — the per-decode-step fast path. The with-form
        (``span(..., ledger=True)``) costs ~5 Python frames per record;
        this pair costs 2, on the step whose host time the 3% overhead
        gate of ``chip_smoke.py`` prices. NOT exception-safe: a raise
        between open and close leaves the nesting guard held (and the
        exception propagates: telemetry catches nothing) — use the
        with-form anywhere that isn't the measured hot loop."""
        if self._ledger_depth:
            raise RuntimeError("nested ledger spans would double-claim "
                               "the attribution invariant")
        self._ledger_depth = 1
        led = self._ledger
        if led is None:
            return (0, 0, self.tracer.now_us())
        s = led.totals
        return (s.offloaded_flops + s.fallback_flops + s.residual_flops,
                s.offloaded_calls + s.fallback_calls,
                self.tracer.now_us())

    def ledger_close(self, h: tuple, name: str, cat: str = "step",
                     track: int = ENGINE_TRACK, rid: Optional[int] = None,
                     args: Optional[Dict[str, Any]] = None) -> None:
        """Close half of ``ledger_open``: claims the exact FLOP/call
        delta toward the invariant and journals the span record (the journal
        append is the tracer's own close-time representation)."""
        f1, c1 = self._ledger_now()
        f0, c0, ts = h
        df, dc = f1 - f0, c1 - c0
        if args is None:
            args = {}
        args["flops"] = df
        args["calls"] = dc
        tr = self.tracer
        tr._j.append(("X", name, cat, track, rid, ts, tr.now_us() - ts,
                      args))
        self.claimed_flops += df
        self.claimed_calls += dc
        self._ledger_depth = 0

    # -- lifecycle + instants (thin tracer passthrough) -----------------
    def begin(self, rid: int, name: str, **args: Any) -> None:
        self.tracer.begin(rid, name, **args)

    def end(self, rid: int, name: str, **args: Any) -> None:
        self.tracer.end(rid, name, **args)

    def instant(self, name: str, rid: Optional[int] = None,
                **args: Any) -> None:
        self.tracer.instant(name, rid=rid, **args)

    # -- metrics (declare-or-lookup passthrough) ------------------------
    def inc(self, name: str, v: float = 1.0, **labels: Any) -> None:
        self.metrics.counter(name).inc(v, **labels)

    def observe(self, name: str, v: float) -> None:
        self.metrics.histogram(name).observe(v)

    def gauge(self, name: str, v: float, **labels: Any) -> None:
        self.metrics.gauge(name).set(v, **labels)

    # -- snapshot / export ----------------------------------------------
    def sync_ledger_metrics(self) -> None:
        """Copy the bound ledger's totals into the ledger-fed counters —
        called at snapshot/export time; the ledger is the source of
        truth, the counters are its exposition. The ``device`` series
        are the ledger's ``by_device``: one a mesh device under sharded
        serving (``dev0``, ``dev1``, ...), ``dev0`` alone unsharded."""
        if self._ledger is None:
            return
        s = self._ledger.totals
        flops = self.metrics.counter("repro_ledger_flops_total")
        flops.set_total(s.offloaded_flops, kind="offloaded")
        flops.set_total(s.fallback_flops, kind="fallback")
        flops.set_total(s.residual_flops, kind="residual")
        for dev, v in sorted(s.by_device.items()):
            flops.set_total(v, device=dev)
        # per-role split of a two-model (speculative) engine: sums to the
        # kind= totals exactly
        for role, v in sorted(s.by_role.items()):
            flops.set_total(v, role=role)
        calls = self.metrics.counter("repro_ledger_calls_total")
        for backend, v in sorted(s.by_backend.items()):
            calls.set_total(v, backend=backend)

    def snapshot(self) -> Dict[str, Any]:
        """One JSON-safe dict: metrics + trace shape + the ledger
        consistency record — what ``launch/serve.py`` prints as the
        consolidated report and ``--metrics-out`` persists."""
        self.sync_ledger_metrics()
        return {
            "metrics": self.metrics.snapshot(),
            "trace": {"spans": len(self.tracer.spans),
                      "events": len(self.tracer.events),
                      "open_phases": self.tracer.open_phases(),
                      "requests_opened": len(self.tracer.rids_opened),
                      "requests_closed": len(self.tracer.rids_closed)},
            "ledger_consistency": self.ledger_consistent(),
        }

    def write_trace(self, path: str) -> str:
        return export.write_trace(self.tracer, path)

    def write_metrics(self, path: str) -> str:
        self.sync_ledger_metrics()
        return export.write_metrics(self.metrics, path)


class _LedgerSpanCtx(_SpanCtx):
    """``Telemetry.span(..., ledger=True)``: a tracer span that also
    claims the bound ledger's exact FLOP/call delta."""
    __slots__ = ("_tele", "_f0", "_c0")

    def __init__(self, tele: Telemetry, name: str, cat: str, track: int,
                 rid: Optional[int], args: Dict[str, Any]):
        super().__init__(tele.tracer, name, cat, track, rid, args)
        self._tele = tele

    def __enter__(self) -> "_LedgerSpanCtx":
        tele = self._tele
        if tele._ledger_depth:
            raise RuntimeError(
                "nested ledger spans would double-claim the "
                f"attribution invariant (opening {self._name!r})")
        tele._ledger_depth = 1
        self._f0, self._c0 = tele._ledger_now()
        return super().__enter__()

    def __exit__(self, *exc) -> None:
        # claim into the args dict BEFORE the journal append in
        # super().__exit__ snapshots it into the record
        tele = self._tele
        f1, c1 = tele._ledger_now()
        df, dc = f1 - self._f0, c1 - self._c0
        self._args["flops"] = df
        self._args["calls"] = dc
        tele.claimed_flops += df
        tele.claimed_calls += dc
        tele._ledger_depth = 0
        super().__exit__(*exc)


def maybe_span(tele: Optional[Telemetry], name: str, **kwargs):
    """``tele.span(...)`` or a free ``nullcontext`` — the pattern every
    instrumentation site uses so the disabled path allocates nothing."""
    if tele is None:
        return nullcontext()
    return tele.span(name, **kwargs)
