"""The program's spans and counters, in memory.

A span is a named interval on the host's monotonic clock
(`time.perf_counter_ns`), with the span that was open around it (its
parent) and a few attributes (`it` for a training step, `frame` for a
frame, `tile` for a tile). Counters are named integers in one table. The
trainers, the tester, the tiled renderer, the kernel builder and K1's
wrappers record them where their work happens:

- `train.chunk` (`it`, `steps`) with `train.chunk.indices` (the index
  draw), `train.chunk.copy` (indices to the device), `train.step` (`it`)
  per iteration and `train.chunk.read` (the loss scalars to the host);
  then `train.log` (`it`), the logging of the chunk's scalars;
- inside `train.step`: `train.gather`, then per sub-batch `train.forward`,
  `train.losses` and `train.backward`, then `train.adam`;
- `render.frame` (`frame`) with `render.prepare`, `render.tile` (`tile`)
  per tile, `render.gather` (the tiles' outputs to the host) and
  `render.outputs`;
- `app.<stage>` for a dataset app's stages, `kernels.build` (`library`) per
  library compiled;
- counters `k1.launches.<kernel>` (K1's instances, its backward kernels
  and their yardsticks on the card) and `jpeg.decodes`.

While a `torch.profiler` session is active, whoever started it, each span
also opens `torch.profiler.record_function` under its name, so the
program's spans lie on the profiler's timeline beside the device's
kernels; and the finer spans inside `render_rays` (`detail`: sampling,
each MLP launch, compositing, resampling) are recorded only then.

A span given a CUDA `device` also records a timing event on that
device's current stream (as the span opens) at each end (the forward, the
backward and the frame), or at its end alone with `start_event=False` (a
training step after its chunk's first, which the step before it bounds):
`collect`, called where the program already waits for the device (the
chunk's read of its scalars, the frame's copy to the host), reads them
back into the span's `device_ms`, its (start, end) on the device's
timeline in milliseconds from the device's first timed span (float32, as
CUDA gives it: a few microseconds of resolution in a run's first minutes),
the start None where no event marked it. A caller that never calls it has
its spans collected every `PENDING` timed spans. The events come from a
pool that is reused; on the CPU `device_ms` stays None.

Records go into one ring per span name of `CAPACITY` spans each: the
oldest of a name drop out first, so a run's many step spans never push out
its chunks or stages. `snapshot()` returns them and the counters,
`reset()` clears both. Nothing is written anywhere. One tracer serves the process (the module's
functions); a rank of a multi-device run sends rank 0's snapshot back to
its launcher, which `merge`s it.
"""

import collections
import contextlib
import itertools
import threading
import time
from typing import Any, Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

CAPACITY = 1 << 15  # spans kept per name: a 60 s window holds ~1.2k steps or ~4.5k tiles
PENDING = 4096  # timed spans held for `collect`: a caller that never calls it is collected here
_OFF = contextlib.nullcontext()


def profiling() -> bool:
    """Whether a torch.profiler session is recording (the profiler's own flag)."""
    return _autograd_profiler._is_profiler_enabled


class Span:
    """One span: a context manager that records itself in its tracer when
    it closes, also when an exception closes it."""

    __slots__ = ("tracer", "name", "attrs", "device", "start_event", "id", "parent", "start_ns", "end_ns",
                 "device_ms", "closed", "_function", "_stream", "_events")

    def __init__(self, tracer: "Tracer", name: str, device: Optional[torch.device], attrs: Dict[str, Any],
                 start_event: bool = True):
        self.tracer, self.name, self.attrs, self.device = tracer, name, attrs, device
        self.start_event = start_event
        self.device_ms = None

    def __enter__(self) -> "Span":
        stack = self.tracer._stack()
        self.parent = stack[-1] if stack else None
        self.id = next(self.tracer._ids)
        stack.append(self.id)
        self._function = None
        if profiling():
            self._function = torch.profiler.record_function(self.name)
            self._function.__enter__()
        self._events = None
        if self.device is not None and self.device.type == "cuda":
            self._stream = torch.cuda.current_stream(self.device)
            self._events = (self.tracer._event(self.device, self._stream) if self.start_event else None, None)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events = (self._events[0], self.tracer._event(self.device, self._stream))
            self._stream = None
            self.tracer._pending.append(self)
            if len(self.tracer._pending) >= PENDING:
                self.tracer.collect()
        if self._function is not None:
            self._function.__exit__(*exc)
            self._function = None
        self.tracer._stack().pop()
        self.tracer._keep(self)
        return False

    def record(self) -> Dict[str, Any]:
        return {"name": self.name, "id": self.id, "parent": self.parent, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "attrs": dict(self.attrs),
                "device_ms": None if self.device_ms is None else list(self.device_ms)}


class Tracer:
    """A ring of spans per name, a table of counters and a pool of CUDA
    timing events."""

    def __init__(self, capacity: int = CAPACITY):
        self._capacity = capacity
        self._rings: Dict[str, collections.deque] = {}  # per span name
        self._counts: Dict[str, int] = {}
        self._ids = itertools.count(1)
        self._closes = itertools.count()  # the order spans closed in
        self._local = threading.local()
        self._pending: List[Span] = []  # closed spans whose events are not read yet
        self._free: List[torch.cuda.Event] = []
        self._epochs: Dict[int, torch.cuda.Event] = {}  # per device: the event device_ms counts from

    def _stack(self) -> List[int]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _keep(self, span: Span) -> None:
        span.closed = next(self._closes)
        ring = self._rings.get(span.name)
        if ring is None:
            ring = self._rings[span.name] = collections.deque(maxlen=self._capacity)
        ring.append(span)

    def _event(self, device: torch.device, stream: torch.cuda.Stream) -> torch.cuda.Event:
        """A pooled timing event recorded on `stream` of `device` (the
        device's epoch event first, at its first use)."""
        index = device.index if device.index is not None else torch.cuda.current_device()
        if index not in self._epochs:
            self._epochs[index] = torch.cuda.Event(enable_timing=True)
            self._epochs[index].record(stream)
        event = self._free.pop() if self._free else torch.cuda.Event(enable_timing=True)
        event.record(stream)
        return event

    def span(self, name: str, device: Optional[torch.device] = None, start_event: bool = True, **attrs) -> Span:
        """A span named `name` with `attrs`; with a CUDA `device`, timed on
        its current stream too (at its end alone without `start_event`)."""
        return Span(self, name, device, attrs, start_event)

    def detail(self, name: str, **attrs):
        """A span that is recorded only while a profiler session is active."""
        return Span(self, name, None, attrs) if profiling() else _OFF

    def add(self, name: str, start_ns: int, end_ns: int, **attrs) -> None:
        """Record an interval measured elsewhere (a process the program
        waited for), as a child of the innermost open span."""
        span = Span(self, name, None, attrs)
        stack = self._stack()
        span.parent, span.id = (stack[-1] if stack else None), next(self._ids)
        span.start_ns, span.end_ns = start_ns, end_ns
        self._keep(span)

    def count(self, name: str, n: int = 1) -> None:
        self._counts[name] = self._counts.get(name, 0) + n

    def counts(self, prefix: str = "") -> Dict[str, int]:
        return {k: v for k, v in self._counts.items() if k.startswith(prefix)}

    def collect(self) -> None:
        """Read back the timing events of closed spans that the device has
        passed, into their `device_ms`; the others wait for a later call.
        Waits for nothing: call it after a synchronisation."""
        done, waiting = [], []
        for span in self._pending:
            (done if span._events[1].query() else waiting).append(span)
        self._pending = waiting
        for span in done:
            index = span.device.index if span.device.index is not None else torch.cuda.current_device()
            epoch = self._epochs[index]
            span.device_ms = tuple(None if e is None else epoch.elapsed_time(e) for e in span._events)
            self._free.extend(e for e in span._events if e is not None)
            span._events = None

    def snapshot(self) -> Dict[str, Any]:
        """{"spans": [record, ...] in the order they closed, "counts": {...}};
        a record is {name, id, parent, start_ns, end_ns, attrs, device_ms}."""
        self.collect()
        spans = sorted(itertools.chain.from_iterable(self._rings.values()), key=lambda s: s.closed)
        return {"spans": [s.record() for s in spans], "counts": dict(self._counts)}

    def merge(self, snapshot: Dict[str, Any]) -> None:
        """Add another process's snapshot (a rank's): its spans under new
        ids, its roots as children of the innermost open span; its counters
        added to these."""
        stack = self._stack()
        root = stack[-1] if stack else None
        records = snapshot["spans"]
        ids = {r["id"]: next(self._ids) for r in records}
        for r in records:
            span = Span(self, r["name"], None, dict(r["attrs"]))
            span.id, span.parent = ids[r["id"]], ids.get(r["parent"], root)
            span.start_ns, span.end_ns = r["start_ns"], r["end_ns"]
            span.device_ms = None if r["device_ms"] is None else tuple(r["device_ms"])
            self._keep(span)
        for name, n in snapshot["counts"].items():
            self.count(name, n)

    def reset(self) -> None:
        """Drop every span and counter (events in flight are dropped too)."""
        self._rings.clear()
        self._counts.clear()
        self._pending = []


_TRACER = Tracer()
span = _TRACER.span
detail = _TRACER.detail
add = _TRACER.add
count = _TRACER.count
counts = _TRACER.counts
collect = _TRACER.collect
snapshot = _TRACER.snapshot
merge = _TRACER.merge
reset = _TRACER.reset

