"""Lightweight span/event tracer for the serving path — the port's copy
of the reference's ``repro.obs.trace``.

Records *where inside a request* the milliseconds (and, via ledger-delta
spans, the FLOPs feeding PDP/EDP) went, with strictly host-side
bookkeeping: nothing here runs inside a captured CUDA graph, and nothing
here reads a device tensor or synchronizes the device. Every record call
happens between program runs (a graph replay on the card, a recorded
call on the CPU), after the host sync that a step already makes.

Two span families share one ``Span`` record:

  stack spans     ``Tracer.span(...)`` context manager — engine/scheduler
                  host work (``decode_step``, ``prefill``, ``replay``,
                  ``plan_build``). Properly nested per track by
                  construction (it is a with-block).
  phase spans     ``begin(rid, name)`` / ``end(rid, name)`` — the
                  per-request lifecycle (``queued`` -> ``prefill``/
                  ``attach`` -> ``decode``, re-entering ``queued`` on
                  preemption). Each request gets its own track, phases
                  are explicit open/close so any admit/evict/preempt
                  interleaving is recordable; ``open_phases()`` after a
                  drain must be empty — the closed-lifecycle invariant
                  ``chip_smoke.py``'s telemetry phase gates.

Instant events (``instant``) mark the schedulers' decisions: ``submit``,
``prefix_hit``, ``cow_split``, ``preempt``, ``replay``, ``evict``,
``spec_admit``, ``spec_trim``.

Hot-path representation: record calls append flat tuples to a journal
and ``Span`` objects materialize lazily on first access to ``spans``/
``events`` (cached until the journal grows). A captured slot step takes
about a millisecond of host time on the card, and the overhead gate is
3% of it, so the hot path is a clock read and a tuple append, nothing
more.

Tracks map to Perfetto threads in the export (obs/export.py): track 0 is
the engine/scheduler host loop, track ``1 + rid`` is request ``rid``.
``check_nesting()`` verifies the containment discipline the validator
(tools/check_trace.py) re-checks on the exported JSON.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

#: track id of the engine/scheduler host loop; requests live at 1 + rid
ENGINE_TRACK = 0


def request_track(rid: int) -> int:
    return 1 + rid


@dataclass
class Span:
    """One recorded interval (or instant, when ``dur_us`` is None and
    ``instant`` is True). ``args`` lands verbatim in the trace_event
    ``args`` dict — ledger deltas (``flops``, ``calls``) live there."""
    name: str
    cat: str
    track: int
    ts_us: float
    dur_us: Optional[float] = None
    rid: Optional[int] = None
    instant: bool = False
    args: Dict[str, Any] = field(default_factory=dict)

    @property
    def closed(self) -> bool:
        return self.instant or self.dur_us is not None


class Tracer:
    """Append-only span/event recorder with a monotonic µs clock.

    ``clock`` is injectable (tests drive a virtual clock); timestamps are
    relative to construction so traces start near t=0. The recorder never
    drops or reorders: ``spans`` materializes in *close* order,
    ``events`` in emit order; the exporter sorts by ``ts_us`` (Perfetto
    wants non-decreasing timestamps, checked by tools/check_trace.py).
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        # journal records: ("X", name, cat, track, rid, ts, dur, args)
        # for closed spans of either family (appended at close time, so
        # journal order is close order); ("i", name, cat, track, rid,
        # ts, args) for instants
        self._j: List[tuple] = []
        # open lifecycle phases: (rid, name) -> (ts_us, cat, args)
        self._open: Dict[Tuple[int, str], tuple] = {}
        self._depth = 0                      # open stack spans
        self.rids_opened: set = set()
        self.rids_closed: set = set()
        self._mat_n = -1                     # journal length at last mat.
        self._spans: List[Span] = []
        self._events: List[Span] = []

    # -- clock ----------------------------------------------------------
    def now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    # -- stack spans ----------------------------------------------------
    def span(self, name: str, cat: str = "host", track: int = ENGINE_TRACK,
             rid: Optional[int] = None,
             args: Optional[Dict[str, Any]] = None):
        """Context manager recording one closed interval on ``track``.
        The tracer takes ownership of ``args`` (no defensive copy — this
        is the per-decode-step hot path; pass a fresh dict)."""
        return _SpanCtx(self, name, cat, track, rid,
                        args if args is not None else {})

    # -- lifecycle phases ----------------------------------------------
    def begin(self, rid: int, name: str, cat: str = "lifecycle",
              **args: Any) -> None:
        """Open lifecycle phase ``name`` on request ``rid``'s track.
        Re-opening an already-open (rid, name) phase is a programming
        error — the interleaving property test drives this."""
        key = (rid, name)
        if key in self._open:
            raise RuntimeError(f"phase {name!r} already open for rid {rid}")
        self._open[key] = (self.now_us(), cat, args)
        self.rids_opened.add(rid)

    def end(self, rid: int, name: str, **args: Any) -> None:
        key = (rid, name)
        ent = self._open.pop(key, None)
        if ent is None:
            raise RuntimeError(f"phase {name!r} not open for rid {rid}")
        ts, cat, bargs = ent
        if args:
            bargs.update(args)
        self._j.append(("X", name, cat, 1 + rid, rid, ts,
                        self.now_us() - ts, bargs))
        if not any(k[0] == rid for k in self._open):
            self.rids_closed.add(rid)

    def phase_open(self, rid: int, name: str) -> bool:
        return (rid, name) in self._open

    def open_phases(self) -> List[Tuple[int, str]]:
        """Still-open lifecycle phases — empty after a full drain (the
        closed-lifecycle invariant)."""
        return sorted(self._open)

    def open_phase_spans(self) -> List[Span]:
        """The open phases as (unclosed) ``Span`` records, for the
        exporter's dangling-``"B"`` emission."""
        return [Span(name=name, cat=v[1], track=1 + rid, ts_us=v[0],
                     rid=rid, args=dict(v[2]))
                for (rid, name), v in sorted(self._open.items())]

    def open_stack_depth(self) -> int:
        return self._depth

    # -- instants -------------------------------------------------------
    def instant(self, name: str, cat: str = "sched",
                rid: Optional[int] = None, track: Optional[int] = None,
                **args: Any) -> None:
        if track is None:
            track = ENGINE_TRACK if rid is None else 1 + rid
        self._j.append(("i", name, cat, track, rid, self.now_us(), args))

    # -- lazy materialization ------------------------------------------
    def _materialize(self) -> None:
        if self._mat_n == len(self._j):
            return
        spans: List[Span] = []
        events: List[Span] = []
        for r in self._j:
            if r[0] == "X":
                spans.append(Span(name=r[1], cat=r[2], track=r[3],
                                  ts_us=r[5], dur_us=r[6], rid=r[4],
                                  args=r[7]))
            else:
                events.append(Span(name=r[1], cat=r[2], track=r[3],
                                   ts_us=r[5], rid=r[4], instant=True,
                                   args=r[6]))
        self._spans, self._events, self._mat_n = spans, events, len(self._j)

    @property
    def spans(self) -> List[Span]:
        """Closed spans (both families), in close order."""
        self._materialize()
        return self._spans

    @property
    def events(self) -> List[Span]:
        """Instant events, in emit order."""
        self._materialize()
        return self._events

    # -- invariants -----------------------------------------------------
    def all_closed(self) -> bool:
        return not self._open and self._depth == 0

    def check_nesting(self) -> List[str]:
        """Per-track containment check: any two closed spans on one track
        are either disjoint or one contains the other (the property the
        interleaving test asserts; tools/check_trace.py re-derives it on
        the exported JSON). Returns human-readable violations."""
        errors: List[str] = []
        by_track: Dict[int, List[Span]] = {}
        for sp in self.spans:
            by_track.setdefault(sp.track, []).append(sp)
        for track, spans in sorted(by_track.items()):
            spans = sorted(spans, key=lambda s: (s.ts_us, -(s.dur_us or 0)))
            stack: List[Span] = []
            for sp in spans:
                end = sp.ts_us + (sp.dur_us or 0.0)
                while stack and sp.ts_us >= _end(stack[-1]) - 1e-6:
                    stack.pop()
                if stack and end > _end(stack[-1]) + 1e-6:
                    errors.append(
                        f"track {track}: span {sp.name!r} "
                        f"[{sp.ts_us:.1f}, {end:.1f}] overlaps "
                        f"{stack[-1].name!r} ending {_end(stack[-1]):.1f}")
                stack.append(sp)
        return errors


def _end(sp: Span) -> float:
    return sp.ts_us + (sp.dur_us or 0.0)


class _SpanCtx:
    """The with-block behind ``Tracer.span`` — one clock read on enter,
    one clock read + one journal append on exit (recorded on exit, so a
    span is never left open by an exception either)."""
    __slots__ = ("_tracer", "_name", "_cat", "_track", "_rid", "_args",
                 "_ts")

    def __init__(self, tracer: Tracer, name: str, cat: str, track: int,
                 rid: Optional[int], args: Dict[str, Any]):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._track = track
        self._rid = rid
        self._args = args

    def __enter__(self) -> "_SpanCtx":
        tr = self._tracer
        tr._depth += 1
        self._ts = tr.now_us()
        return self

    def __exit__(self, *exc) -> None:
        tr = self._tracer
        tr._depth -= 1
        tr._j.append(("X", self._name, self._cat, self._track, self._rid,
                      self._ts, tr.now_us() - self._ts, self._args))
