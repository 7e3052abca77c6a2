"""A copy of ``repro.obs.trace`` (stdlib only).

Bounded ring-buffer trace recorder with Chrome trace-event export.

The recorder collects **spans** (durations) and **events** (instants)
into a deque bounded by ``capacity``; when full the *oldest* events are
dropped and counted (``n_dropped``) — recording never grows without
bound and never raises.  Export is the Chrome trace-event JSON format
(``{"traceEvents": [...]}``) which Perfetto (https://ui.perfetto.dev)
and ``chrome://tracing`` load directly:

* synchronous ``B``/``E`` duration spans and ``X`` complete spans live
  on ``(pid, tid)`` tracks — the engine puts its fused-step timeline
  (``step`` with ``dispatch`` / ``device_wait`` children, and sampled
  per-layer attribution spans inside ``device_wait``) on pid 0;
* asynchronous ``b``/``e`` spans keyed by ``id`` model one track per
  *request* on a separate process (``REQUEST_PID``): a ``request``
  envelope span plus nested phase spans (``queued`` / ``prefill`` /
  ``decode``) that follow the request through preemption and requeue,
  with instant (``n``) events attached for preemption, retry,
  quarantine, shed, and chaos injections;
* ``C`` counter events (:meth:`counter`) render as Perfetto counter
  tracks — the engine samples free pages, active/waiting slots,
  windowed tokens/s, and preemption/shed totals each traced step so
  resource timelines sit beside the spans.

Every track is *named*: :meth:`to_chrome` prepends ``M`` metadata
events (``process_name`` / ``thread_name``) for each (pid, tid) the
event stream actually uses, so Perfetto shows "repro-engine /
fused-step" instead of bare numbers.

Timestamps come from ``time.perf_counter()`` relative to recorder
construction, in microseconds (the unit the trace format mandates) —
real durations even when the engine runs its deterministic virtual
clock, so device-wait spans stay meaningful in tests.

The exported file also carries a top-level ``repro`` metadata block
(engine metrics snapshot, chaos seed, drop count) that
``benchmarks/check_invariants.py --kind trace`` gates the event stream
against: every request must own exactly one terminal span, spans must
nest and never dangle, the step-span count must equal the engine's
``metrics()["steps"]``, and chaos traces must contain one injection
event per counted injected fault.

Live consumers poll :meth:`segment`: an incremental drain keyed by a
monotonically increasing global event cursor, so the telemetry
endpoint's ``/trace`` route can stream the event log mid-run without
rewinding or double-reading (events that fell off the ring before a
reader caught up are reported, not silently skipped).

Disabled tracing costs the engine one ``is not None`` predicate per
hook — callers hold ``None`` instead of a recorder; there is no "off"
mode inside the recorder itself.
"""
from __future__ import annotations

import json
import pathlib
import time
from collections import deque

# async request spans share one category so Perfetto groups them by id
REQUEST_CAT = "request"
# request tracks live on their own process so the per-request async rows
# don't interleave with the engine's fused-step timeline
ENGINE_PID = 0
REQUEST_PID = 1
# engine-process thread ids with stable Perfetto names
STEP_TID = 0
ATTRIB_TID = 1

_PROCESS_NAMES = {ENGINE_PID: "repro-engine", REQUEST_PID: "repro-requests"}
_THREAD_NAMES = {
    (ENGINE_PID, STEP_TID): "fused-step",
    (ENGINE_PID, ATTRIB_TID): "layer-attribution",
    (REQUEST_PID, 0): "requests",
}


class TraceRecorder:
    """Append-only, bounded span/event recorder (one per engine run)."""

    def __init__(self, capacity: int = 1 << 16):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._events: deque[dict] = deque()
        self.n_dropped = 0
        self._t0 = time.perf_counter()
        self.metadata: dict = {}
        # per-request bookkeeping so phase transitions close the previous
        # phase span automatically (and re-attachment never double-begins)
        self._phase: dict[int, str] = {}
        self._seen: set[int] = set()

    # -- clock -------------------------------------------------------------

    def now(self) -> float:
        """Absolute perf_counter seconds (pass to :meth:`complete`)."""
        return time.perf_counter()

    def _ts(self, t: float | None = None) -> float:
        return ((self.now() if t is None else t) - self._t0) * 1e6

    # -- raw event plumbing ------------------------------------------------

    def _push(self, ev: dict) -> None:
        if len(self._events) >= self.capacity:
            self._events.popleft()
            self.n_dropped += 1
        self._events.append(ev)

    def _emit(self, name: str, ph: str, *, pid: int = ENGINE_PID, tid: int = 0,
              t: float | None = None, **extra) -> None:
        ev = {"name": name, "ph": ph, "ts": self._ts(t), "pid": pid, "tid": tid}
        ev.update(extra)
        self._push(ev)

    # -- synchronous spans (per-tid stack discipline) ----------------------

    def begin(self, name: str, *, tid: int = 0, **args) -> None:
        self._emit(name, "B", tid=tid, args=args)

    def end(self, name: str, *, tid: int = 0, **args) -> None:
        self._emit(name, "E", tid=tid, args=args)

    def complete(self, name: str, t_start: float, t_end: float, *,
                 tid: int = 0, **args) -> None:
        """One ``X`` span from two :meth:`now` readings — nothing is
        recorded between the readings, so timing a region costs two
        perf_counter calls and zero recorder work until it closes."""
        self._emit(name, "X", tid=tid, t=t_start,
                   dur=(t_end - t_start) * 1e6, args=args)

    def instant(self, name: str, *, tid: int = 0, **args) -> None:
        self._emit(name, "i", tid=tid, s="t", args=args)

    def counter(self, name: str, *, t: float | None = None, **values) -> None:
        """One sample on a Perfetto **counter track** (``C`` event): each
        keyword is a series on the track named ``name``.  Values must be
        numeric — Perfetto plots them as a stacked timeline."""
        self._emit(name, "C", t=t, args={k: float(v) for k, v in values.items()})

    # -- per-request async spans -------------------------------------------

    def req_begin(self, rid: int, **args) -> None:
        """Open a request's envelope span (idempotent per rid, so run()
        can re-attach already-submitted requests without duplicates)."""
        if rid in self._seen:
            return
        self._seen.add(rid)
        self._emit("request", "b", pid=REQUEST_PID, id=rid, cat=REQUEST_CAT,
                   args=args)

    def req_phase(self, rid: int, phase: str, **args) -> None:
        """Transition a request to ``phase``, closing the previous phase
        span; a no-op when the request is already in that phase."""
        prev = self._phase.get(rid)
        if prev == phase:
            return
        if prev is not None:
            self._emit(prev, "e", pid=REQUEST_PID, id=rid, cat=REQUEST_CAT,
                       args={})
        self._phase[rid] = phase
        self._emit(phase, "b", pid=REQUEST_PID, id=rid, cat=REQUEST_CAT,
                   args=args)

    def phase(self, rid: int) -> str | None:
        """The request's currently-open phase span name (or None)."""
        return self._phase.get(rid)

    def req_event(self, rid: int, name: str, **args) -> None:
        """Instant event on a request's track (preempt, retry, shed, ...)."""
        self._emit(name, "n", pid=REQUEST_PID, id=rid, cat=REQUEST_CAT,
                   args=args)

    def req_end(self, rid: int, status: str, **args) -> None:
        """Close the current phase and the envelope span — the request's
        exactly-one **terminal span**, carrying its terminal status."""
        prev = self._phase.pop(rid, None)
        if prev is not None:
            self._emit(prev, "e", pid=REQUEST_PID, id=rid, cat=REQUEST_CAT,
                       args={})
        self._emit("request", "e", pid=REQUEST_PID, id=rid, cat=REQUEST_CAT,
                   args={"status": status, **args})

    # -- export ------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._events)

    @property
    def events(self) -> list[dict]:
        return list(self._events)

    @property
    def cursor(self) -> int:
        """Global index one past the newest recorded event (monotonic —
        drops advance the window's *start*, never this end)."""
        return self.n_dropped + len(self._events)

    def segment(self, since: int = 0) -> tuple[list[dict], int, int]:
        """Incremental drain: events with global index >= ``since``.

        Returns ``(events, next_cursor, missed)`` — pass ``next_cursor``
        back as the next ``since`` to stream the log without rewinding.
        ``missed`` counts events that fell off the bounded ring before
        this reader caught up (0 for a reader polling faster than the
        buffer turns over)."""
        if since < 0:
            raise ValueError("since must be >= 0")
        evs = list(self._events)  # snapshot: readers may sit on a thread
        start = self.n_dropped
        missed = max(0, start - since)  # asked-for events already dropped
        lo = max(since - start, 0)
        return evs[lo:], start + len(evs), missed

    def name_metadata(self) -> list[dict]:
        """``M`` metadata events naming every (pid, tid) the recorded
        stream uses, so Perfetto labels the tracks instead of showing
        bare numbers.  Deterministic order: processes, then threads."""
        pids, tids = {ENGINE_PID}, {(ENGINE_PID, STEP_TID)}
        for e in self._events:
            pid = e.get("pid", ENGINE_PID)
            pids.add(pid)
            if e.get("ph") in ("B", "E", "X", "i", "C", "b", "e", "n"):
                tids.add((pid, e.get("tid", 0)))
        out = []
        for pid in sorted(pids):
            out.append({
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": _PROCESS_NAMES.get(pid, f"pid-{pid}")},
            })
        for pid, tid in sorted(tids):
            out.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": _THREAD_NAMES.get((pid, tid), f"tid-{tid}")},
            })
        return out

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON payload (Perfetto-loadable) with the
        ``repro`` metadata block the trace gates check against."""
        return {
            "traceEvents": self.name_metadata() + self.events,
            "displayTimeUnit": "ms",
            "repro": {**self.metadata, "dropped": self.n_dropped,
                      "n_events": len(self._events)},
        }

    def save(self, path: str | pathlib.Path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_chrome()) + "\n")
        return path
