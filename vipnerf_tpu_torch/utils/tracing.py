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
  then `train.log` (`it`, `scalars`: the logger's `add_scalar` calls),
  the logging of the chunk's scalars;
- inside `train.step`: `train.gather`, then per sub-batch `train.forward`,
  `train.losses` and `train.backward`, then `train.adam`; inside
  `train.forward`, per level with other views, `rays.<level>.sec_dirs` (the
  other views' origins and their directions to the samples,
  `models/vip_nerf.py`), timed on the device;
- `render.frame` (`frame`) with `render.prepare`, `render.tile` (`tile`)
  per tile, `render.gather` (the tiles' outputs to the host) and
  `render.outputs`;
- `app.<stage>` for a dataset app's stages, `kernels.build` (`library`) per
  library compiled;
- counters `k1.launches.<kernel>` (K1's instances, its encode and its
  backward kernels on the card), `vis.sec_view_points` (points x other
  views through K1's view branch, per K1 forward call from its shapes) and
  `jpeg.decodes`; `train.graph.captures` and `train.graph.replays` (the
  step's CUDA graph, `train/step.py`); `train.rays.nerf` and
  `train.rays.sparse_depth` (each step's rays of each stream, summed over
  the scenes, from the index blocks' shapes at the step's gather, which
  runs on the host before every step, replayed or not) and
  `train.log.scalars` (the scalars `train.log` spans logged).

While a `torch.profiler` session is active, whoever started it, each span
also opens `torch.profiler.record_function` under its name, so the
program's spans lie on the profiler's timeline beside the device's
kernels; and the finer spans inside `render_rays` (`detail`: sampling,
each MLP launch, compositing, resampling, and outside training the other
views' directions) are recorded only then.

A span given a CUDA `device` also records a timing event on that
device's current stream (as the span opens) at each end (the forward, the
other views' directions in training, the backward and the frame), or at
its end alone with `start_event=False` (a training step after its chunk's
first, which the step before it bounds):
`collect`, called where the program already waits for the device (the
chunk's read of its scalars, the frame's copy to the host), reads them
back into the span's `device_ms`, its (start, end) on the device's
timeline in milliseconds from the device's first timed span (float32, as
CUDA gives it: a few microseconds of resolution in a run's first minutes),
the start None where no event marked it. A caller that never calls it has
its spans collected every `PENDING` timed spans. The events come from a
pool that is reused; on the CPU `device_ms` stays None.

A step replayed as a CUDA graph (`train/step.py` `GraphedStep`) ran its
host code once, at the capture. While a capture records (`capture`), the
counters it bumps and its spans timed on the device are kept in a
`Recording` instead of the table and the rings: such a span takes its two
ends from the device's global timer, written by a one-thread kernel
(`csrc/trace_stamps.cu`) into the row of pinned host memory that the
current replay owns (the graph advances the row on the device), since an
event recorded into a graph marks no time. Each replay (`replay`) adds the
recorded counts to the table again and the recorded spans to the rings,
their roots as children of the innermost open span (the step's
`train.step`), their host interval the replay's launch; `collect` reads
their `device_ms` from the stamps once the replay has finished, in
milliseconds from the first stamp the tracer read (double precision; only
a span's end less its start means anything). A replay's spans are the
recorded device-timed ones alone: `train.forward`, `train.backward`,
`rays.<level>.sec_dirs` and `k1.trunk_backward`; the host-only
`train.losses` and `train.adam` are absent, as host work of the capture.
`annotate` sets attributes of the innermost open span (`graph` on a
replayed `train.step`).

Records go into one ring per span name of `CAPACITY` spans each: the
oldest of a name drop out first, so a run's many step spans never push out
its chunks or stages. `snapshot()` returns them and the counters,
`reset()` clears both. Nothing is written anywhere. One tracer serves the process (the module's
functions); a rank of a multi-device run sends rank 0's snapshot back to
its launcher, which `merge`s it.
"""

import collections
import contextlib
import ctypes
import itertools
import threading
import time
from typing import Any, Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

CAPACITY = 1 << 15  # spans kept per name: a 60 s window holds ~1.2k steps or ~4.5k tiles
PENDING = 4096  # timed spans held for `collect`: a caller that never calls it is collected here
STAMP_ROWS = 512  # replays of one recording whose stamps wait for `collect`
STAMP_SLOTS = 256  # span ends a recording may stamp
_OFF = contextlib.nullcontext()


def profiling() -> bool:
    """Whether a torch.profiler session is recording (the profiler's own flag)."""
    return _autograd_profiler._is_profiler_enabled


class Span:
    """One span: a context manager that records itself in its tracer when
    it closes, also when an exception closes it."""

    __slots__ = ("tracer", "name", "attrs", "device", "start_event", "id", "parent", "start_ns", "end_ns",
                 "device_ms", "closed", "_function", "_stream", "_events", "_slots")

    def __init__(self, tracer: "Tracer", name: str, device: Optional[torch.device], attrs: Dict[str, Any],
                 start_event: bool = True):
        self.tracer, self.name, self.attrs, self.device = tracer, name, attrs, device
        self.start_event = start_event
        self.device_ms = None

    def __enter__(self) -> "Span":
        stack = self.tracer._stack()
        self.parent = stack[-1].id if stack else None
        self.id = next(self.tracer._ids)
        stack.append(self)
        self._function = None
        if profiling():
            self._function = torch.profiler.record_function(self.name)
            self._function.__enter__()
        self._events = self._slots = None
        recording = self.tracer._recording
        if recording is not None:
            self._slots = recording.enter(self)
        elif self.device is not None and self.device.type == "cuda":
            self._stream = torch.cuda.current_stream(self.device)
            self._events = (self.tracer._event(self.device, self._stream) if self.start_event else None, None)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        if self._slots is not None:  # recorded for the replays, kept by none
            self.tracer._recording.exit(self)
            if self._function is not None:
                self._function.__exit__(*exc)
                self._function = None
            self.tracer._stack().pop()
            return False
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


class Recording:
    """What a capture recorded (`Tracer.capture`): the counters it bumped,
    and its spans timed on the device as a template that each replay adds
    again, their ends stamped by the graph into a row of `stamps` per
    replay (pinned host memory on CUDA; on the CPU a plain tensor that no
    kernel writes)."""

    def __init__(self, device: Optional[torch.device]):
        self.device = device
        self.counts: Dict[str, int] = {}
        # (name, attrs, id, recorded parent's id or None, start slot or None, end slot), in closing order
        self.spans: List[tuple] = []
        self.slots = 0
        self.replays = 0
        self._timed = set()
        self._up: Dict[int, Optional[int]] = {}  # span id -> its nearest recorded ancestor's id
        self.cuda = device is not None and device.type == "cuda"
        self.stamps = torch.zeros((STAMP_ROWS, STAMP_SLOTS), dtype=torch.int64, pin_memory=self.cuda)
        self.row = torch.zeros(1, dtype=torch.int32, device=device) if self.cuda else None
        self._stamps_device = _device_pointer(self.stamps) if self.cuda else None

    def enter(self, span: "Span") -> tuple:
        up = span.parent if span.parent in self._timed else self._up.get(span.parent)
        self._up[span.id] = up
        if span.device is None:
            return ()
        self._timed.add(span.id)
        return (self._stamp() if span.start_event else None,)

    def exit(self, span: "Span") -> None:
        if span.device is not None:
            self.spans.append((span.name, dict(span.attrs), span.id, self._up[span.id], span._slots[0],
                               self._stamp()))

    def _stamp(self) -> int:
        """The next slot, stamped with the device's timer on the current stream."""
        slot = self.slots
        if slot >= STAMP_SLOTS:
            raise RuntimeError(f"a capture stamps at most {STAMP_SLOTS} span ends")
        self.slots += 1
        if self.cuda:
            _launch_stamp(self._stamps_device, self.row, slot, torch.cuda.current_stream(self.device))
        return slot

    def finish(self) -> None:
        """The graph's last node: the next replay stamps the next row."""
        if self.cuda:
            _launch_advance(self.row, torch.cuda.current_stream(self.device))


# the stamp kernels' C entries (csrc/trace_stamps.cu), their library built at its first use

def _typed(fn, *argtypes):
    if fn.argtypes is None:
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    return fn


def _device_pointer(host: torch.Tensor) -> int:
    """The device's address of pinned host memory."""
    from vipnerf_tpu_torch.kernels import build

    fn = _typed(build.load("trace_stamps").vipnerf_trace_device_pointer, ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_void_p))
    ptr = ctypes.c_void_p()
    rc = fn(host.data_ptr(), ctypes.byref(ptr))
    if rc != 0:
        raise RuntimeError(f"the tracer's stamps are not mapped into the device: cudaError {rc}")
    return ptr.value


def _launch_stamp(stamps: int, row: torch.Tensor, slot: int, stream) -> None:
    from vipnerf_tpu_torch.kernels import build

    fn = _typed(build.load("trace_stamps").vipnerf_trace_stamp, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p)
    rc = fn(stamps, row.data_ptr(), STAMP_SLOTS, slot, stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the tracer's stamp launch failed: cudaError {rc}")


def _launch_advance(row: torch.Tensor, stream) -> None:
    from vipnerf_tpu_torch.kernels import build

    fn = _typed(build.load("trace_stamps").vipnerf_trace_advance, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)
    rc = fn(row.data_ptr(), STAMP_ROWS, stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the tracer's row advance failed: cudaError {rc}")


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
        self._recording: Optional[Recording] = None  # the capture under way
        self._replays: List[tuple] = []  # (recording, row, event, [(span, start slot, end slot)]) not read yet
        self._stamp_epoch: Optional[int] = None  # the first stamp read, ns: replayed device_ms count from it

    def _stack(self) -> List[Span]:
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
        span.parent, span.id = (stack[-1].id if stack else None), next(self._ids)
        span.start_ns, span.end_ns = start_ns, end_ns
        self._keep(span)

    def count(self, name: str, n: int = 1) -> None:
        table = self._counts if self._recording is None else self._recording.counts
        table[name] = table.get(name, 0) + n

    def annotate(self, **attrs) -> None:
        """Set attributes of the innermost open span (of this thread)."""
        stack = self._stack()
        if stack:
            stack[-1].attrs.update(attrs)

    @contextlib.contextmanager
    def capture(self, recording: Recording):
        """Record the counters and device-timed spans of the code inside,
        which a CUDA graph captures, into `recording` (made before the
        capture: its row counter must not be the graph's); on the way out,
        the graph's last node advances the stamps' row."""
        if self._recording is not None:
            raise RuntimeError("a capture is already being recorded")
        self._recording = recording
        try:
            yield recording
            recording.finish()
        finally:
            self._recording = None

    @contextlib.contextmanager
    def replay(self, recording: Recording):
        """Around one launch of the graph that captured `recording`: its
        counts added to the table, its spans to the rings (roots under the
        innermost open span), their device_ms read by `collect` once the
        launch has finished."""
        row = recording.replays % STAMP_ROWS
        if any(r[0] is recording and r[1] == row for r in self._replays):
            for r in self._replays:  # this launch overwrites the row: read it first
                if r[0] is recording and r[1] == row and r[2] is not None:
                    r[2].synchronize()
            self.collect()
        t0 = time.perf_counter_ns()
        yield
        t1 = time.perf_counter_ns()
        recording.replays += 1
        for name, n in recording.counts.items():
            self._counts[name] = self._counts.get(name, 0) + n
        stack = self._stack()
        root = stack[-1].id if stack else None
        ids, made = {}, []
        for name, attrs, sid, up, start, end in recording.spans:
            span = Span(self, name, recording.device, dict(attrs))
            span.id, span.start_ns, span.end_ns = next(self._ids), t0, t1
            ids[sid] = span.id
            made.append((span, up, start, end))
        for span, up, _, _ in made:
            span.parent = root if up is None else ids[up]
            self._keep(span)
        event = None
        if recording.cuda:
            event = self._event(recording.device, torch.cuda.current_stream(recording.device))
        self._replays.append((recording, row, event, [(span, start, end) for span, _, start, end in made]))
        if len(self._replays) >= PENDING:
            self.collect()

    def counts(self, prefix: str = "") -> Dict[str, int]:
        return {k: v for k, v in self._counts.items() if k.startswith(prefix)}

    def collect(self) -> None:
        """Read back the timing events of closed spans that the device has
        passed, into their `device_ms`; the others wait for a later call.
        Waits for nothing: call it after a synchronisation."""
        self._collect_replays()
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

    def _collect_replays(self) -> None:
        """device_ms of the spans of every finished replay, from its row of stamps."""
        waiting = []
        for recording, row, event, spans in self._replays:
            if event is not None and not event.query():
                waiting.append((recording, row, event, spans))
                continue
            stamps = recording.stamps[row].tolist()
            if self._stamp_epoch is None:
                self._stamp_epoch = min(stamps[s] for _, a, b in spans for s in (a, b) if s is not None) \
                    if spans else None
            for span, start, end in spans:
                span.device_ms = tuple(None if s is None else (stamps[s] - self._stamp_epoch) / 1e6
                                       for s in (start, end))
            if event is not None:
                self._free.append(event)
        self._replays = waiting

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
        root = stack[-1].id if stack else None
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
        self._replays = []


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
annotate = _TRACER.annotate
capture = _TRACER.capture
replay = _TRACER.replay

