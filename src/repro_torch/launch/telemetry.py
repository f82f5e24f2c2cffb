"""Runtime telemetry: spans and metrics, the part the serving path reads.

Counterpart of src/repro/launch/telemetry.py (pure Python there too), kept
as the port's own copy.  Two layers:

  * **Spans**: nestable, thread-safe wall-clock intervals around every
    elastic iteration phase (seed pass, fused pass, validate, checkpoint,
    re-mesh and the engines' rebuild), every checkpoint write and every
    server scheduler action (admit, oneshot, retire, shed, recover).
    ``sync_on()`` synchronizes the payload's CUDA device before the span
    closes, so the duration covers the device work and not only the
    enqueue; CPU tensors need no sync.
  * **Metrics**: counters, gauges and histograms with FIXED log-spaced
    buckets (any two histograms merge and compare bucket for bucket),
    giving the server its p50/p99 queue wait and latency and its
    per-reason ``degraded`` counters.

Exporters: ``snapshot()``, ``summary()`` (with the plan-vs-actual drift
per op), ``events()``, ``export_jsonl(path)`` (one event a line) and
``export_chrome_trace(path)`` (Chrome/Perfetto ``traceEvents``); ``clear()``
forgets everything.
**Plan-vs-actual**: ``record_plan_actual(plan, measured_s)`` keeps an
ExecutionPlan's modeled cost beside a measured time (with the plan's raw
terms), and ``calibration_records()`` feeds them to
``planner.calibrate()`` unchanged.

Everything is off by default: the module-level recorder is a
``NullRecorder`` whose ``span()`` returns one shared no-op context manager
and whose metric handles do nothing.  Components resolve ``current()`` at
call time, so ``enable()`` or ``with recording() as rec:`` instruments the
stack without threading a recorder through every constructor.
"""
from __future__ import annotations

import contextlib
import json
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Mapping

import torch

__all__ = [
    "Counter", "Gauge", "Histogram", "Recorder", "NullRecorder", "Span",
    "current", "enable", "disable", "recording", "HIST_BOUNDS", "NULL",
]


# -- fixed log-spaced histogram buckets ---------------------------------------
# 1 µs … ~1100 s in ×2 steps.  Out-of-range observations clamp into the edge
# buckets.
HIST_MIN = 1e-6
HIST_FACTOR = 2.0
HIST_BUCKETS = 31
HIST_BOUNDS = tuple(HIST_MIN * HIST_FACTOR ** i for i in range(HIST_BUCKETS))
_LOG_MIN = math.log(HIST_MIN)
_LOG_FACTOR = math.log(HIST_FACTOR)


def _bucket_index(v: float) -> int:
    if v <= HIST_MIN:
        return 0
    i = int((math.log(v) - _LOG_MIN) / _LOG_FACTOR)
    return min(max(i, 0), HIST_BUCKETS - 1)


def _label_key(name: str, labels: Mapping[str, Any]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotone event count (thread-safe)."""
    __slots__ = ("name", "labels", "value", "_lock")

    def __init__(self, name: str, labels: Mapping[str, Any]):
        self.name, self.labels = name, dict(labels)
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> int:
        with self._lock:
            self.value += n
            return self.value


class Gauge:
    """Last-write-wins level."""
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Mapping[str, Any]):
        self.name, self.labels = name, dict(labels)
        self.value = float("nan")

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Log-spaced-bucket histogram of seconds (thread-safe).

    Percentiles interpolate geometrically inside the chosen bucket and are
    clamped to the observed [min, max], so a histogram fed one constant
    value reports that value at every quantile."""
    __slots__ = ("name", "labels", "counts", "count", "sum", "min", "max",
                 "_lock")

    def __init__(self, name: str, labels: Mapping[str, Any]):
        self.name, self.labels = name, dict(labels)
        self.counts = [0] * HIST_BUCKETS
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.counts[_bucket_index(v)] += 1
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)

    def percentile(self, q: float) -> float:
        """Approximate q-quantile (q in [0, 1]) from the bucket counts."""
        if self.count == 0:
            return float("nan")
        target = q * self.count
        seen = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= target:
                lo = HIST_BOUNDS[i]
                hi = lo * HIST_FACTOR
                frac = min(max((target - seen) / c, 0.0), 1.0)
                v = lo * (hi / lo) ** frac          # geometric interpolation
                return min(max(v, self.min), self.max)
            seen += c
        return self.max

    def snapshot(self) -> dict:
        n = self.count
        return {"count": n, "sum_s": self.sum,
                "min_s": self.min if n else None,
                "max_s": self.max if n else None,
                "mean_s": (self.sum / n) if n else None,
                "p50_s": self.percentile(0.50) if n else None,
                "p90_s": self.percentile(0.90) if n else None,
                "p99_s": self.percentile(0.99) if n else None}


# -- spans --------------------------------------------------------------------

@dataclass
class Span:
    """One closed interval on one thread's span stack."""
    id: int
    parent: int | None
    name: str
    tid: int
    t_start_s: float            # seconds since the recorder's epoch
    dur_s: float = 0.0
    attrs: dict = field(default_factory=dict)


def _cuda_devices(payload, out: set) -> set:
    """The CUDA devices of every tensor in `payload` (a tensor, or nested
    tuples, lists, dicts and NamedTuples of them)."""
    if isinstance(payload, torch.Tensor):
        if payload.device.type == "cuda":
            out.add(payload.device)
    elif isinstance(payload, dict):
        for v in payload.values():
            _cuda_devices(v, out)
    elif isinstance(payload, (list, tuple)):
        for v in payload:
            _cuda_devices(v, out)
    return out


def _synchronize(payload) -> None:
    for dev in _cuda_devices(payload, set()):
        torch.cuda.synchronize(dev)


class _SpanCtx:
    """Context manager for one span; created by Recorder.span()."""
    __slots__ = ("_rec", "_span", "_t0", "_payload")

    def __init__(self, rec: "Recorder", name: str, attrs: dict):
        self._rec = rec
        self._payload = None
        stack = rec._stack()
        self._span = Span(id=rec._next_id(),
                          parent=stack[-1] if stack else None, name=name,
                          tid=threading.get_ident(), t_start_s=0.0,
                          attrs=attrs)

    def annotate(self, **attrs) -> "_SpanCtx":
        self._span.attrs.update(attrs)
        return self

    def sync_on(self, payload) -> "_SpanCtx":
        """Synchronize `payload`'s CUDA device(s) before the span closes, so
        the duration covers the device work the span launched."""
        self._payload = payload
        return self

    @property
    def dur_s(self) -> float:
        return self._span.dur_s

    def __enter__(self) -> "_SpanCtx":
        self._rec._stack().append(self._span.id)
        self._t0 = time.perf_counter()
        self._span.t_start_s = self._t0 - self._rec.epoch
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._payload is not None:
            _synchronize(self._payload)
        self._span.dur_s = time.perf_counter() - self._t0
        stack = self._rec._stack()
        if stack and stack[-1] == self._span.id:
            stack.pop()
        if exc_type is not None:
            self._span.attrs["error"] = f"{exc_type.__name__}: {exc}" \
                if exc is not None else exc_type.__name__
        self._rec._commit(self._span)


class _NullSpanCtx:
    """Shared no-op span: one module-level instance, no allocation on the
    disabled path."""
    __slots__ = ()
    dur_s = 0.0

    def annotate(self, **attrs):
        return self

    def sync_on(self, payload):
        return self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None


class _NullMetric:
    """Shared no-op counter/gauge/histogram."""
    __slots__ = ()
    value = 0
    count = 0

    def inc(self, n: int = 1) -> int:
        return 0

    def set(self, v: float) -> None:
        return None

    def observe(self, v: float) -> None:
        return None

    def percentile(self, q: float) -> float:
        return float("nan")

    def snapshot(self) -> dict:
        return {}


_NULL_SPAN = _NullSpanCtx()
_NULL_METRIC = _NullMetric()


# -- the recorder -------------------------------------------------------------

class Recorder:
    """One telemetry sink: spans + metrics registry.

    ``spans=False`` keeps the metrics live but makes ``span()`` return the
    shared no-op context (the mode SolverServer uses for its always-on
    counters).  ``max_spans`` bounds memory: past it, new spans are dropped
    and counted in ``spans_dropped``."""
    enabled = True

    def __init__(self, *, spans: bool = True, max_spans: int = 100_000):
        self.record_spans = spans
        self.max_spans = int(max_spans)
        self.epoch = time.perf_counter()
        self.epoch_unix = time.time()
        self.spans: list[Span] = []
        self.spans_dropped = 0
        self._metrics: dict[str, Any] = {}
        self._plan_actual: list[dict] = []
        self._lock = threading.Lock()
        self._ids = iter(range(1, 1 << 62)).__next__
        self._local = threading.local()

    def _stack(self) -> list[int]:
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def _next_id(self) -> int:
        with self._lock:
            return self._ids()

    def _commit(self, span: Span) -> None:
        with self._lock:
            if len(self.spans) >= self.max_spans:
                self.spans_dropped += 1
                return
            self.spans.append(span)

    def span(self, name: str, **attrs):
        """Open a nested span; use as ``with rec.span("phase") as sp:``."""
        if not self.record_spans:
            return _NULL_SPAN
        return _SpanCtx(self, name, attrs)

    # -- metrics registry -----------------------------------------------------

    def _metric(self, cls, name: str, labels: Mapping[str, Any]):
        key = _label_key(name, labels)
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.setdefault(key, cls(name, labels))
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._metric(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._metric(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._metric(Histogram, name, labels)

    def counters(self, name: str) -> dict[str, int]:
        """{label-suffix: value} for every counter named `name` (the
        per-reason breakdown, e.g. ``counters("serve.degraded")``)."""
        out = {}
        for m in list(self._metrics.values()):
            if isinstance(m, Counter) and m.name == name:
                lbl = ",".join(f"{k}={v}" for k, v in sorted(m.labels.items()))
                out[lbl or "total"] = m.value
        return out

    # -- plan-vs-actual -------------------------------------------------------

    def record_plan_actual(self, plan, measured_s: float, **attrs) -> dict:
        """Attach a measured time to an ExecutionPlan: op, choice, modeled,
        measured and their ratio (the drift), and the plan's raw terms, so
        the record feeds ``planner.calibrate()`` unchanged."""
        from repro_torch.launch import planner as _planner
        rec = _planner.actual_record(plan, measured_s)
        rec.update(attrs)
        with self._lock:
            self._plan_actual.append(rec)
        return rec

    def plan_actual(self) -> list[dict]:
        with self._lock:
            return list(self._plan_actual)

    def calibration_records(self) -> list[dict]:
        """The plan-vs-actual records that carry raw terms: what
        ``planner.calibrate()`` and ``MachineModel.calibrate()`` take."""
        return [r for r in self.plan_actual() if "flops" in r]

    # -- exporters ------------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-safe point-in-time view of every metric and the span
        counts."""
        counters, gauges, hists = {}, {}, {}
        for key, m in sorted(self._metrics.items()):
            if isinstance(m, Counter):
                counters[key] = m.value
            elif isinstance(m, Gauge):
                gauges[key] = None if math.isnan(m.value) else m.value
            else:
                hists[key] = m.snapshot()
        return {"counters": counters, "gauges": gauges,
                "histograms": hists, "spans": len(self.spans),
                "spans_dropped": self.spans_dropped}

    def summary(self) -> dict:
        """Compact digest for ``Result.info["trace"]``: total time per span
        phase, the plan-vs-actual drift per op (measured over modeled
        seconds, summed over its records), and the counters."""
        phases: dict[str, dict] = {}
        with self._lock:
            spans = list(self.spans)
            pa = list(self._plan_actual)
        for s in spans:
            p = phases.setdefault(s.name, {"count": 0, "total_s": 0.0,
                                           "max_s": 0.0})
            p["count"] += 1
            p["total_s"] += s.dur_s
            p["max_s"] = max(p["max_s"], s.dur_s)
        drift: dict[str, dict] = {}
        for r in pa:
            d = drift.setdefault(r["op"], {"records": 0, "modeled_s": 0.0,
                                           "measured_s": 0.0})
            d["records"] += 1
            d["modeled_s"] += r["modeled_s"]
            d["measured_s"] += r["measured_s"]
        for d in drift.values():
            d["ratio"] = (d["measured_s"] / d["modeled_s"]
                          if d["modeled_s"] > 0 else None)
        return {"spans": len(spans), "phases": phases,
                "plan_vs_actual": drift,
                "counters": dict(self.snapshot()["counters"])}

    def events(self) -> list[dict]:
        """Every recorded event as a JSON-safe dict (the JSONL payload):
        spans, plan-vs-actual records, counters, gauges, histograms."""
        with self._lock:
            spans = list(self.spans)
            pa = list(self._plan_actual)
        out = [{"type": "span", "id": s.id, "parent": s.parent,
                "name": s.name, "tid": s.tid, "t_start_s": s.t_start_s,
                "dur_s": s.dur_s, "attrs": s.attrs} for s in spans]
        out += [dict(r, type="plan_actual") for r in pa]
        snap = self.snapshot()
        for kind in ("counters", "gauges"):
            for key, v in snap[kind].items():
                out.append({"type": kind[:-1], "key": key, "value": v})
        for key, h in snap["histograms"].items():
            out.append(dict(h, type="histogram", key=key))
        return out

    def export_jsonl(self, path) -> int:
        """Write one JSON event per line; returns the event count."""
        evs = self.events()
        with open(path, "w") as f:
            for e in evs:
                f.write(json.dumps(e, default=_json_default) + "\n")
        return len(evs)

    def chrome_trace(self) -> dict:
        """Chrome/Perfetto ``traceEvents`` document of the span timeline
        (complete "X" events, µs timebase; one row per thread)."""
        events: list[dict] = [
            {"name": "process_name", "ph": "M", "pid": 0,
             "args": {"name": "repro solver"}}]
        tids: dict[int, int] = {}
        with self._lock:
            spans = list(self.spans)
        for s in spans:
            tid = tids.setdefault(s.tid, len(tids))
            events.append({
                "name": s.name, "ph": "X", "pid": 0, "tid": tid,
                "ts": round(s.t_start_s * 1e6, 3),
                "dur": round(s.dur_s * 1e6, 3),
                "args": {k: _json_safe(v) for k, v in s.attrs.items()}})
        for real_tid, tid in tids.items():
            events.append({"name": "thread_name", "ph": "M", "pid": 0,
                           "tid": tid,
                           "args": {"name": f"thread-{real_tid}"}})
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"epoch_unix_s": self.epoch_unix}}

    def export_chrome_trace(self, path) -> int:
        doc = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(doc["traceEvents"])

    def clear(self) -> None:
        """Forget every span, metric and plan-vs-actual record."""
        with self._lock:
            self.spans.clear()
            self.spans_dropped = 0
            self._metrics.clear()
            self._plan_actual.clear()


def _json_safe(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def _json_default(v):
    """JSON for what json.dumps cannot write: a number (a 0-d tensor, a
    numpy scalar) as a float, anything else as its str."""
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


class NullRecorder(Recorder):
    """The disabled default: every operation is a no-op returning shared
    singletons."""
    enabled = False

    def __init__(self):
        super().__init__(spans=False, max_spans=0)

    def span(self, name: str, **attrs):
        return _NULL_SPAN

    def counter(self, name: str, **labels):
        return _NULL_METRIC

    def gauge(self, name: str, **labels):
        return _NULL_METRIC

    def histogram(self, name: str, **labels):
        return _NULL_METRIC

    def record_plan_actual(self, plan, measured_s: float, **attrs) -> dict:
        return {}


NULL = NullRecorder()
_current: Recorder = NULL


def current() -> Recorder:
    """The active module-level recorder (a NullRecorder unless enabled)."""
    return _current


def enable(recorder: Recorder | None = None) -> Recorder:
    """Install `recorder` (or a fresh one) as the module default."""
    global _current
    _current = recorder if recorder is not None else Recorder()
    return _current


def disable() -> None:
    global _current
    _current = NULL


@contextlib.contextmanager
def recording(recorder: Recorder | None = None):
    """Scoped enable(): installs a recorder for the body and restores the
    previous one after."""
    global _current
    prev = _current
    rec = recorder if recorder is not None else Recorder()
    _current = rec
    try:
        yield rec
    finally:
        _current = prev
