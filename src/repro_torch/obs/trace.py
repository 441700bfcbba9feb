"""Request-lifecycle tracing in Chrome/Perfetto trace-event JSON.

A copy of the reference's ``obs/trace.py``; the port's engines emit the
same events.

A :class:`Tracer` records two kinds of tracks:

* **pid 0 — "engine"**: one complete ("X") event per device dispatch
  (``prefill_dispatch`` / ``decode_block`` / ``spec_round``), so the
  engine's duty cycle and batching are visible at a glance, plus
  counter ("C") tracks sampling queue depth, live slots and page-pool
  occupancy at the same block boundaries;
* **pid 1 — "requests"**: one thread (tid = request id) per request,
  carrying its lifecycle spans — ``request`` (submit → retire) encloses
  ``queue`` (submit → admit, re-opened after a preemption: the readmit
  wait), then per-dispatch ``prefill_chunk`` / ``decode_block`` /
  ``spec_round`` complete events whose args carry tokens / pages /
  policy labels, plus ``preempt`` instant markers.  The closing
  ``request`` span's args carry the request's terminal ``outcome``
  (``ok | shed | timed_out | failed`` — see ``repro_torch.resil.errors``), and resilient
  engines add ``fault`` instants on the engine track (an injected or
  real transient dispatch error, with its kind) and ``cancel`` instants
  on the request track (deadline expiry / retries exhausted).

Every timestamp is a host ``time.perf_counter()`` the engines already
take for their existing latency accounting — tracing never adds a
device sync (the ``sync_count`` audit is unchanged with tracing on).
A disabled tracer (the default) is a no-op on every call.

``write()`` emits ``{"traceEvents": [...]}`` JSON that loads directly
in https://ui.perfetto.dev or ``chrome://tracing``; a whole Poisson
drive becomes one scrollable timeline.
"""
from __future__ import annotations

import json
import time
from typing import Optional

PID_ENGINE = 0
PID_REQUESTS = 1


class Tracer:
    """Chrome trace-event recorder (see module docstring)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.events: list = []
        self._t0 = time.perf_counter()
        self._named_tids: set = set()
        if enabled:
            for pid, name in ((PID_ENGINE, "engine"),
                              (PID_REQUESTS, "requests")):
                self.events.append({"ph": "M", "name": "process_name",
                                    "pid": pid, "tid": 0,
                                    "args": {"name": name}})

    # ------------------------------------------------------------------
    def _us(self, t_s: Optional[float]) -> float:
        """Host seconds (perf_counter domain) -> trace microseconds."""
        t = time.perf_counter() if t_s is None else t_s
        return (t - self._t0) * 1e6

    def name_thread(self, tid: int, name: str,
                    pid: int = PID_REQUESTS) -> None:
        if not self.enabled or (pid, tid) in self._named_tids:
            return
        self._named_tids.add((pid, tid))
        self.events.append({"ph": "M", "name": "thread_name", "pid": pid,
                            "tid": tid, "args": {"name": name}})

    def begin(self, name: str, tid: int, *, pid: int = PID_REQUESTS,
              ts: Optional[float] = None, args: Optional[dict] = None):
        """Open a nesting span ("B"); close with :meth:`end`."""
        if not self.enabled:
            return
        ev = {"ph": "B", "name": name, "pid": pid, "tid": tid,
              "ts": self._us(ts)}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def end(self, name: str, tid: int, *, pid: int = PID_REQUESTS,
            ts: Optional[float] = None, args: Optional[dict] = None):
        if not self.enabled:
            return
        ev = {"ph": "E", "name": name, "pid": pid, "tid": tid,
              "ts": self._us(ts)}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def complete(self, name: str, tid: int, t0_s: float, t1_s: float, *,
                 pid: int = PID_REQUESTS, args: Optional[dict] = None):
        """Record a closed span ("X") from host timestamps already
        taken (the per-dispatch t0/t1 the engines measure anyway)."""
        if not self.enabled:
            return
        ev = {"ph": "X", "name": name, "pid": pid, "tid": tid,
              "ts": self._us(t0_s),
              "dur": max((t1_s - t0_s) * 1e6, 0.0)}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name: str, tid: int, *, pid: int = PID_REQUESTS,
                ts: Optional[float] = None, args: Optional[dict] = None):
        if not self.enabled:
            return
        ev = {"ph": "i", "name": name, "pid": pid, "tid": tid,
              "ts": self._us(ts), "s": "t"}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, name: str, values: dict, *, pid: int = PID_ENGINE,
                tid: int = 0, ts: Optional[float] = None):
        """Perfetto counter track ("C"): one sampled value per series in
        ``values``.  Engines emit these at block boundaries (queue depth,
        live slots, page-pool occupancy) from host state they already
        hold, so utilization timelines render alongside the spans at
        zero added syncs."""
        if not self.enabled:
            return
        self.events.append({"ph": "C", "name": name, "pid": pid,
                            "tid": tid, "ts": self._us(ts),
                            "args": {k: float(v) for k, v in values.items()}})

    # ------------------------------------------------------------------
    def to_json(self) -> dict:
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms"}

    def write(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)


def request_span_trees(trace: dict) -> dict:
    """Rebuild each request track's span tree from a trace-event dict
    (the shape :meth:`Tracer.to_json` writes).  Returns ``{rid:
    {"complete": bool, "spans": [...], "stack_ok": bool}}`` where
    ``spans`` is every closed span on the track as ``(name, t0_us,
    t1_us, args)`` — the test/CI helper for span invariants; raises on
    malformed B/E nesting only via ``stack_ok=False`` so callers can
    assert with context."""
    tracks: dict = {}
    for ev in trace["traceEvents"]:
        if ev.get("pid") != PID_REQUESTS or ev.get("ph") == "M":
            continue
        tracks.setdefault(ev["tid"], []).append(ev)
    out = {}
    for tid, evs in tracks.items():
        evs.sort(key=lambda e: e["ts"])
        stack, spans, ok = [], [], True
        for ev in evs:
            if ev["ph"] == "B":
                stack.append(ev)
            elif ev["ph"] == "E":
                if not stack or stack[-1]["name"] != ev["name"]:
                    ok = False
                    continue
                b = stack.pop()
                spans.append((b["name"], b["ts"], ev["ts"],
                              {**b.get("args", {}), **ev.get("args", {})}))
            elif ev["ph"] == "X":
                spans.append((ev["name"], ev["ts"],
                              ev["ts"] + ev.get("dur", 0.0),
                              ev.get("args", {})))
        out[tid] = {"complete": ok and not stack
                    and any(s[0] == "request" for s in spans),
                    "spans": spans, "stack_ok": ok and not stack}
    return out
