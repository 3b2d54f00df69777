"""Zero-dependency metrics registry: counters, gauges, fixed-bucket
histograms, Prometheus text exposition — the port's copy of the
reference's ``repro.obs.metrics``, metric names, help strings and
exposition bytes unchanged.

Everything here is plain Python over dicts and lists, so the serving
loop pulls no metrics client in:

  ``Counter``    monotonic, optionally labeled (``inc(v, backend="x")``).
                 Ledger-fed counters are *set* to the ``OffloadLedger``
                 totals at snapshot time rather than incremented — the
                 ledger is already the source of truth.
  ``Gauge``      last-write-wins, optionally labeled.
  ``Histogram``  fixed upper-bound buckets (+Inf implicit). Bucket counts
                 are cumulative in the exposition (Prometheus ``le``
                 convention) and raw per-bucket in snapshots;
                 ``sum(bucket_counts) == count`` always.

One percentile implementation serves every consumer: ``percentile()``
(numpy-free linear interpolation, matching ``np.percentile``'s default)
is what ``Histogram.percentile`` uses over retained observations, and
what ``chip_smoke.py``'s latency summaries call.

``MetricsRegistry.snapshot()`` returns one nested dict (JSON-safe);
``render_prometheus()`` emits the text exposition format, so
``launch/serve.py --metrics-out`` can drop a file any Prometheus scraper
or ``promtool check metrics`` ingests.
"""
from __future__ import annotations

import math
from bisect import bisect_left
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

#: default latency buckets (seconds): 4 per decade from 10 µs to 100 s —
#: wide enough for queue waits under bursty load, fine enough that a
#: bucket-only percentile stays within ~1.8x of exact (10^(1/4) spacing)
LATENCY_BUCKETS_S: Tuple[float, ...] = tuple(
    round(10.0 ** (exp / 4.0), 10) for exp in range(-20, 9))

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> _LabelKey:
    if not labels:           # hot path: unlabeled per-step instruments
        return ()
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _label_str(key: _LabelKey) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


def percentile(values: Sequence[float], q: float) -> float:
    """The repo's one percentile implementation: linear interpolation
    between closest ranks (numpy's default 'linear' method), so swapping
    a benchmark's ``np.percentile`` call for this one changes no numbers.
    ``q`` is in [0, 100]; empty input returns 0.0."""
    xs = sorted(values)
    n = len(xs)
    if n == 0:
        return 0.0
    if n == 1:
        return float(xs[0])
    pos = (q / 100.0) * (n - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return float(xs[lo] + (xs[hi] - xs[lo]) * frac)


@dataclass
class Counter:
    name: str
    help: str = ""

    _values: Dict[_LabelKey, float] = field(default_factory=dict, repr=False)

    def inc(self, v: float = 1.0, **labels: Any) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = _label_key(labels)
        self._values[key] = self._values.get(key, 0.0) + v

    def set_total(self, v: float, **labels: Any) -> None:
        """Overwrite a series total — the ledger-fed path: the
        ``OffloadLedger`` already holds exact monotonic totals, so
        snapshot-time sync copies them instead of diffing."""
        self._values[_label_key(labels)] = float(v)

    def value(self, **labels: Any) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def series(self) -> Dict[str, float]:
        return {_label_str(k) or "": v for k, v in sorted(self._values.items())}


@dataclass
class Gauge:
    name: str
    help: str = ""

    _values: Dict[_LabelKey, float] = field(default_factory=dict, repr=False)

    def set(self, v: float, **labels: Any) -> None:
        self._values[_label_key(labels)] = float(v)

    def value(self, **labels: Any) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def series(self) -> Dict[str, float]:
        return {_label_str(k) or "": v for k, v in sorted(self._values.items())}


class Histogram:
    """Fixed-bucket histogram with the shared percentile implementation.

    ``buckets`` are finite upper bounds (ascending); an implicit +Inf
    bucket catches the tail, so ``sum(bucket_counts) == count`` always
    (property-tested). ``track_values=True`` retains raw observations so
    ``percentile`` is exact — the benchmarks' mode (bounded workloads);
    the serving registry keeps ``track_values=False`` (bounded memory for
    unbounded serve loops) and interpolates within the bucket instead.
    """

    def __init__(self, name: str, buckets: Iterable[float] = LATENCY_BUCKETS_S,
                 help: str = "", track_values: bool = False):
        self.name = name
        self.help = help
        self.buckets: Tuple[float, ...] = tuple(sorted(buckets))
        if not self.buckets:
            raise ValueError(f"histogram {name} needs at least one bucket")
        self.bucket_counts: List[int] = [0] * (len(self.buckets) + 1)
        self.count = 0
        self.sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None
        self.track_values = track_values
        self._values: List[float] = []

    def observe(self, v: float) -> None:
        v = float(v)
        self.bucket_counts[bisect_left(self.buckets, v)] += 1
        self.count += 1
        self.sum += v
        self._min = v if self._min is None else min(self._min, v)
        self._max = v if self._max is None else max(self._max, v)
        if self.track_values:
            self._values.append(v)

    def percentile(self, q: float) -> float:
        """q-th percentile: exact over retained values when tracking,
        else linear interpolation inside the covering bucket (lower edge
        = previous bound or the observed min; upper = bound or max)."""
        if self.count == 0:
            return 0.0
        if self.track_values:
            return percentile(self._values, q)
        # find the bucket holding the q-th rank, interpolate inside it
        rank = (q / 100.0) * (self.count - 1)
        cum = 0
        for i, c in enumerate(self.bucket_counts):
            if c == 0:
                continue
            if cum + c > rank:
                lo = self.buckets[i - 1] if i > 0 else (self._min or 0.0)
                hi = (self.buckets[i] if i < len(self.buckets)
                      else (self._max if self._max is not None else lo))
                lo = max(lo, self._min if self._min is not None else lo)
                hi = min(hi, self._max if self._max is not None else hi)
                frac = (rank - cum) / c
                return float(lo + (hi - lo) * frac)
            cum += c
        return float(self._max or 0.0)

    def snapshot(self) -> Dict[str, Any]:
        return {"count": self.count, "sum": self.sum,
                "min": self._min, "max": self._max,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99),
                "buckets": list(zip([*self.buckets, math.inf],
                                    self.bucket_counts))}


class MetricsRegistry:
    """Name -> instrument map with one-call declaration-or-lookup (so
    instrumentation sites never race a central declaration list)."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str, help: str = "") -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name, help)
        return c

    def gauge(self, name: str, help: str = "") -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name, help)
        return g

    def histogram(self, name: str, buckets: Iterable[float] = LATENCY_BUCKETS_S,
                  help: str = "", track_values: bool = False) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(
                name, buckets, help, track_values=track_values)
        return h

    # -- export --------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """One nested JSON-safe dict of everything."""
        return {
            "counters": {n: c.series() for n, c in
                         sorted(self._counters.items())},
            "gauges": {n: g.series() for n, g in sorted(self._gauges.items())},
            "histograms": {n: h.snapshot() for n, h in
                           sorted(self._histograms.items())},
        }

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4: HELP/TYPE headers,
        cumulative ``le`` histogram buckets, ``+Inf`` terminal bucket."""
        lines: List[str] = []
        for name, c in sorted(self._counters.items()):
            if c.help:
                lines.append(f"# HELP {name} {c.help}")
            lines.append(f"# TYPE {name} counter")
            series = c.series() or {"": 0.0}
            for label, v in series.items():
                lines.append(f"{name}{label} {_fmt(v)}")
        for name, g in sorted(self._gauges.items()):
            if g.help:
                lines.append(f"# HELP {name} {g.help}")
            lines.append(f"# TYPE {name} gauge")
            series = g.series() or {"": 0.0}
            for label, v in series.items():
                lines.append(f"{name}{label} {_fmt(v)}")
        for name, h in sorted(self._histograms.items()):
            if h.help:
                lines.append(f"# HELP {name} {h.help}")
            lines.append(f"# TYPE {name} histogram")
            cum = 0
            for bound, cnt in zip([*h.buckets, math.inf], h.bucket_counts):
                cum += cnt
                le = "+Inf" if math.isinf(bound) else _fmt(bound)
                lines.append(f'{name}_bucket{{le="{le}"}} {cum}')
            lines.append(f"{name}_sum {_fmt(h.sum)}")
            lines.append(f"{name}_count {h.count}")
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def serving_registry() -> MetricsRegistry:
    """The serving stack's standard instrument set — the reference's
    names and help strings, byte for byte — declared up front so snapshots and expositions are stable even before
    the first request touches a given path."""
    r = MetricsRegistry()
    r.histogram("repro_queue_wait_seconds",
                help="submit -> admission wait per request")
    r.histogram("repro_ttft_seconds",
                help="submit -> first streamed token per request")
    r.histogram("repro_step_seconds",
                help="one fixed-shape batch decode step (wall)")
    r.histogram("repro_token_seconds",
                help="per-token latency (step wall / active slots)")
    r.histogram("repro_prefill_seconds",
                help="batch-1 admission prefill (wall)")
    r.histogram("repro_replay_seconds",
                help="preempt-and-recompute replay (wall, DESIGN.md §15.5)")
    r.gauge("repro_queue_depth", help="requests waiting for a slot")
    r.gauge("repro_slots_active", help="slots holding a live request")
    r.gauge("repro_step_traces", help="decode step_fn trace count (1 = "
            "zero retraces after warmup)")
    r.gauge("repro_kv_pages_free", help="free self-KV pages (paged pool)")
    r.gauge("repro_kv_pages_used", help="allocated self-KV pages")
    r.gauge("repro_kv_pages_shared",
            help="pages with refcount > 1 (CoW/prefix sharing)")
    r.gauge("repro_kv_utilization", help="peak used/committed KV bytes")
    r.counter("repro_requests_submitted_total")
    r.counter("repro_requests_finished_total")
    r.counter("repro_tokens_total", help="tokens streamed")
    r.counter("repro_preemptions_total", help="DESIGN.md §15.5 preemptions")
    r.counter("repro_prefix_hits_total",
              help="admissions served from shared cross-KV pages")
    r.counter("repro_cow_splits_total",
              help="copy-on-write page splits (DESIGN.md §15.2)")
    r.counter("repro_evictions_total")
    r.counter("repro_replays_total")
    r.counter("repro_dispatch_total",
              help="backend-registry dispatch resolutions at trace time, "
                   "by segment and backend (DESIGN.md §12)")
    r.counter("repro_ledger_flops_total",
              help="ledger-fed FLOPs by kind/device/role (DESIGN.md §16.3)")
    # speculative decoding: drafted vs accepted token counts and the
    # round count feed the acceptance-rate report
    r.counter("repro_spec_rounds_total",
              help="speculative draft+verify rounds (DESIGN.md §17)")
    r.counter("repro_spec_drafted_total",
              help="draft tokens proposed across active slots")
    r.counter("repro_spec_accepted_total",
              help="draft tokens accepted by the verifier")
    r.gauge("repro_spec_acceptance_rate",
            help="accepted/drafted over the engine lifetime")
    r.gauge("repro_spec_verify_traces", help="verify step_fn trace count "
            "(1 = zero retraces after warmup, DESIGN.md §17.3)")
    # round-boundary admission over speculative rounds
    r.counter("repro_spec_admissions_total",
              help="requests admitted into speculative wave rows at round "
                   "boundaries (DESIGN.md §17.4)")
    r.counter("repro_spec_pages_trimmed_total",
              help="pages released by the post-round rejected-suffix trim "
                   "on the paged speculative scheduler (DESIGN.md §17.4)")
    r.counter("repro_ledger_calls_total",
              help="ledger-fed call counts by backend")
    return r
