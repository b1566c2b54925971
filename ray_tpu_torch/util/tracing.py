"""Distributed tracing: spans that follow a request across driver,
raylet scheduling, and worker execution.

Reference: Ray's OpenTelemetry integration (``python/ray/util/tracing/``:
tracing helpers wrap task submit/execute and inject the OTel context
into the task's runtime metadata so worker-side spans parent correctly)
and the C++ span plumbing in ``src/ray/telemetry/``.

Design here: a dependency-free span recorder with the OTel data model
(trace_id / span_id / parent_id, name, t0/t1, attributes, status). If
``opentelemetry`` is importable we ALSO forward finished spans to the
installed OTel tracer provider — but nothing requires it, matching the
"stub or gate" rule for optional deps. Span context crosses process
boundaries as a small dict (w3c-traceparent-shaped) carried in the task
spec's tracing field; the executing worker re-hydrates it so its
execution span parents the driver's submit span.

Spans land in the worker's task-event buffer alongside task events, so
``ray_tpu_torch.timeline()`` renders them in the same chrome trace.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

_current_span: contextvars.ContextVar[Optional["Span"]] = \
    contextvars.ContextVar("rt_current_span", default=None)

_enabled: Optional[bool] = None


def enabled() -> bool:
    """Tracing is opt-in (reference: RAY_TRACING_ENABLED hook): flag env
    ``RT_tracing_enabled=1`` or programmatic :func:`enable`."""
    global _enabled
    if _enabled is None:
        _enabled = os.environ.get("RT_tracing_enabled", "") in (
            "1", "true", "True")
    return _enabled


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def _new_id(nbytes: int) -> str:
    return uuid.uuid4().hex[: nbytes * 2]


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str] = None
    t0: float = 0.0
    t1: float = 0.0
    attributes: Dict[str, Any] = field(default_factory=dict)
    status: str = "OK"

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def context(self) -> Dict[str, str]:
        """Portable context for cross-process propagation (the shape of
        a w3c traceparent, as a dict for our pickle-framed RPC)."""
        return {"trace_id": self.trace_id, "span_id": self.span_id}


class SpanRecorder:
    """Process-local sink of finished spans (bounded ring)."""

    CAP = 10_000

    def __init__(self) -> None:
        self._spans: List[Span] = []
        self._lock = threading.Lock()

    def record(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)
            if len(self._spans) > self.CAP:
                del self._spans[: self.CAP // 10]

    def drain(self) -> List[Span]:
        with self._lock:
            out, self._spans = self._spans, []
        return out

    def snapshot(self) -> List[Span]:
        with self._lock:
            return list(self._spans)


_recorder = SpanRecorder()


def recorder() -> SpanRecorder:
    return _recorder


def current_span() -> Optional[Span]:
    return _current_span.get()


def current_context() -> Optional[Dict[str, str]]:
    """Context dict to inject into an outgoing task spec (None when
    tracing is off or no span is active)."""
    span = _current_span.get()
    return span.context() if span is not None else None


@contextlib.contextmanager
def span(name: str, *, parent_context: Optional[Dict[str, str]] = None,
         attributes: Optional[Dict[str, Any]] = None):
    """Open a span. Parenting: explicit ``parent_context`` (rehydrated
    from a remote caller) wins, else the process-local current span,
    else a fresh trace root. No-op (yields None) when tracing is off —
    unless a remote context arrived, which means the CALLER is tracing
    and this hop must not break the trace."""
    if not enabled() and parent_context is None:
        yield None
        return
    parent = _current_span.get()
    if parent_context is not None:
        trace_id = parent_context["trace_id"]
        parent_id = parent_context["span_id"]
    elif parent is not None:
        trace_id = parent.trace_id
        parent_id = parent.span_id
    else:
        trace_id = _new_id(16)
        parent_id = None
    s = Span(name=name, trace_id=trace_id, span_id=_new_id(8),
             parent_id=parent_id, t0=time.time(),
             attributes=dict(attributes or {}))
    token = _current_span.set(s)
    try:
        yield s
    except BaseException as e:
        s.status = f"ERROR: {type(e).__name__}"
        raise
    finally:
        s.t1 = time.time()
        _current_span.reset(token)
        _recorder.record(s)
        _forward_otel(s)


def _forward_otel(s: Span) -> None:
    """Best-effort bridge into an installed OpenTelemetry SDK. Our
    trace/span ids are mapped into the OTel SpanContext so exported
    spans keep their cross-process parent links instead of appearing as
    disconnected roots."""
    try:
        from opentelemetry import trace as otel_trace  # type: ignore
        from opentelemetry.trace import (  # type: ignore
            NonRecordingSpan,
            SpanContext,
            TraceFlags,
            set_span_in_context,
        )
    except Exception:  # noqa: BLE001 — otel not installed: local-only
        return
    try:
        tracer = otel_trace.get_tracer("ray_tpu_torch")
        parent_ctx = None
        if s.parent_id:
            parent_sc = SpanContext(
                trace_id=int(s.trace_id, 16), span_id=int(s.parent_id, 16),
                is_remote=True, trace_flags=TraceFlags(TraceFlags.SAMPLED))
            parent_ctx = set_span_in_context(NonRecordingSpan(parent_sc))
        ospan = tracer.start_span(
            s.name, context=parent_ctx, start_time=int(s.t0 * 1e9),
            attributes={k: str(v) for k, v in s.attributes.items()})
        if s.status != "OK":
            from opentelemetry.trace import Status, StatusCode  # type: ignore

            ospan.set_status(Status(StatusCode.ERROR, s.status))
        ospan.end(end_time=int(s.t1 * 1e9))
    except Exception:  # noqa: BLE001 — never fail the traced path
        pass


def spans_to_chrome_events(spans: List[Span], pid: str = "trace") -> list:
    """Chrome-trace 'X' events (same format util/state.py timeline uses),
    one lane per trace so related spans stack visually."""
    events = []
    for s in spans:
        events.append({
            "name": s.name,
            "cat": "span",
            "ph": "X",
            "ts": s.t0 * 1e6,
            "dur": max(0.0, (s.t1 - s.t0)) * 1e6,
            "pid": pid,
            "tid": s.trace_id[:8],
            "args": {**s.attributes, "span_id": s.span_id,
                     "parent_id": s.parent_id or "", "status": s.status},
        })
    return events
