"""Trace and metrics exporters — the port's copy of the reference's
``repro.obs.export``, output unchanged.

``trace_events`` renders a ``Tracer`` to the Chrome/Perfetto
``trace_event`` JSON object format: complete ``"X"`` events for closed
spans, ``"i"`` instants, ``"M"`` metadata naming the tracks (track 0 =
"engine", track 1+rid = "req<rid>"), all sorted by timestamp so the file
satisfies the monotonicity check in tools/check_trace.py. Still-open
spans (a live serve loop exporting mid-flight) are emitted as ``"B"``
begin events without a matching ``"E"`` — deliberately: the validator
flags them, which is exactly the closed-lifecycle gate CI wants to trip
on a scheduler that leaked a request.

Load the output at https://ui.perfetto.dev (or chrome://tracing) — the
README's "Observability" walkthrough shows what to expect.

``write_metrics`` drops a ``MetricsRegistry`` as Prometheus text
exposition; ``write_snapshot`` as JSON. All writers are atomic
(tmp + ``os.replace``).
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, List

from repro_torch.obs.trace import ENGINE_TRACK, Tracer

PID = 1  # single-process serving loop: one pid, tracks are "threads"


def trace_events(tracer: Tracer) -> Dict[str, Any]:
    """The ``trace_event`` JSON object for ``tracer``'s recorded state."""
    events: List[Dict[str, Any]] = []
    tracks = {ENGINE_TRACK}
    for sp in tracer.spans:
        tracks.add(sp.track)
        events.append({"name": sp.name, "cat": sp.cat, "ph": "X",
                       "ts": round(sp.ts_us, 3),
                       "dur": round(sp.dur_us or 0.0, 3),
                       "pid": PID, "tid": sp.track, "args": sp.args})
    for sp in tracer.events:
        tracks.add(sp.track)
        events.append({"name": sp.name, "cat": sp.cat, "ph": "i",
                       "ts": round(sp.ts_us, 3), "s": "t",
                       "pid": PID, "tid": sp.track, "args": sp.args})
    for sp in tracer.open_phase_spans():
        # open phase: "B" with no "E" -- the validator flags it
        tracks.add(sp.track)
        events.append({"name": sp.name, "cat": sp.cat, "ph": "B",
                       "ts": round(sp.ts_us, 3),
                       "pid": PID, "tid": sp.track, "args": sp.args})
    events.sort(key=lambda e: e["ts"])
    meta = [{"name": "process_name", "ph": "M", "pid": PID, "tid": 0,
             "args": {"name": "repro-serve"}}]
    for track in sorted(tracks):
        label = "engine" if track == ENGINE_TRACK else f"req{track - 1}"
        meta.append({"name": "thread_name", "ph": "M", "pid": PID,
                     "tid": track, "args": {"name": label}})
        meta.append({"name": "thread_sort_index", "ph": "M", "pid": PID,
                     "tid": track, "args": {"sort_index": track}})
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def _atomic_write(path: str, text: str) -> str:
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".obs.", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def write_trace(tracer: Tracer, path: str) -> str:
    """Write the Perfetto trace JSON; returns ``path``."""
    return _atomic_write(path, json.dumps(trace_events(tracer), indent=1,
                                          default=str))


def write_metrics(registry, path: str) -> str:
    """Write Prometheus text exposition; returns ``path``."""
    return _atomic_write(path, registry.render_prometheus())


def write_snapshot(snapshot: Dict[str, Any], path: str) -> str:
    """Write a ``Telemetry.snapshot()`` dict as JSON; returns ``path``."""
    return _atomic_write(path, json.dumps(snapshot, indent=1, default=str))
