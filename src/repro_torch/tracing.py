"""Spans and counters inside the port, for a trace of where a request's
host and device time go.

``span(name, **attrs)`` is a context manager around a piece of host work.
While recording is on, each span keeps its name, its start and end on
``time.perf_counter_ns()``, its own id, its parent's id (the span open
around it on the same thread, or None) and a request id, which a span
opened outside every other span starts and every span inside it shares.
``models.transformer.prefill`` opens such a root for each call, with
spans for the embedding, each block, the final norm and the unembedding
inside it, and the layers' ``attn`` / ``mlp`` / ``moe`` / ``mixer`` /
``scan`` spans inside those (``rope``, the rotation of q and k, inside
``attn``, as ``scan`` is inside ``mixer``).

Recording is off by default and only a caller turns it on: ``enable()``
starts a fresh ``Recorder``, ``disable()`` stops it and returns it.  While
it is off, ``span`` returns one shared no-op object: no clock read, no
record.  Nothing here touches the device: no launch, no synchronisation.

Counters: ``count(name)`` bumps a named count at any time (the model
stack counts its attention calls by route, ``attn.k5`` or ``attn.plain``,
and its rotations by style, ``rope.full`` or ``rope.half``);
``counters()`` reads them together with the model kernels' launch counts
(``repro_torch.kernels.launch_counts``).  A span opened with
``counts=True`` records, on exit, how far each of them moved inside it.

``Recorder.clock_offset_ns`` maps a span's times onto the Unix-epoch
nanoseconds of ``time.time_ns()``, the clock of ``torch.profiler``'s
kineto events, so host spans and the device trace line up.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Dict, List, Optional

_COUNTS: Dict[str, int] = {}
_COUNT_LOCK = threading.Lock()


def count(name: str) -> None:
    """Bump the counter ``name`` by one."""
    with _COUNT_LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + 1


def counters() -> Dict[str, int]:
    """Every named count and the model kernels' launch counts, by name."""
    from repro_torch.kernels import launch_counts

    with _COUNT_LOCK:
        out = dict(_COUNTS)
    out.update(launch_counts())
    return out


@dataclasses.dataclass
class SpanRecord:
    """One finished span; ``start_ns`` / ``end_ns`` on
    ``time.perf_counter_ns()``, ``counts`` the counters' deltas of a span
    opened with ``counts=True`` (else None)."""
    id: int
    parent: Optional[int]
    request: int
    name: str
    start_ns: int
    end_ns: int
    attrs: dict
    counts: Optional[Dict[str, int]] = None


class Recorder:
    """The spans of one recording."""

    def __init__(self):
        self.clock_offset_ns = time.time_ns() - time.perf_counter_ns()
        self._done: List[tuple] = []      # SpanRecord's fields, as the spans end
        self._ids = itertools.count(1)
        self._requests = itertools.count(1)
        self._local = threading.local()

    @property
    def records(self) -> List[SpanRecord]:
        """The finished spans, in the order they ended."""
        return [SpanRecord(*fields) for fields in list(self._done)]

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack


class _Span:
    __slots__ = ("_rec", "_name", "_attrs", "_counted", "_id", "_parent",
                 "_request", "_start", "_before")

    def __init__(self, rec: Recorder, name: str, attrs: dict, counted: bool):
        self._rec, self._name, self._attrs, self._counted = rec, name, attrs, counted

    def set(self, **attrs) -> None:
        """Add attributes to the span while it is open."""
        self._attrs.update(attrs)

    def __enter__(self):
        rec = self._rec
        stack = rec._stack()
        self._id = next(rec._ids)
        if stack:
            self._parent, self._request = stack[-1]._id, stack[-1]._request
        else:
            self._parent, self._request = None, next(rec._requests)
        stack.append(self)
        self._before = counters() if self._counted else None
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        rec = self._rec
        rec._stack().pop()
        deltas = None
        if self._before is not None:
            after = counters()
            deltas = {k: v - self._before.get(k, 0) for k, v in after.items()}
        rec._done.append((self._id, self._parent, self._request, self._name,
                          self._start, end, self._attrs, deltas))
        return False


class _NoSpan:
    """What ``span`` returns while recording is off."""
    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()
_active: Optional[Recorder] = None
_last: Optional[Recorder] = None


def span(name: str, *, counts: bool = False, **attrs):
    """A context manager around host work named ``name`` with ``attrs``;
    with ``counts`` it also records the counters' deltas across it.  The
    shared no-op while recording is off."""
    rec = _active
    if rec is None:
        return _NO_SPAN
    return _Span(rec, name, attrs, counts)


def enable() -> Recorder:
    """Start recording into a fresh ``Recorder`` and return it."""
    global _active, _last
    _active = _last = Recorder()
    return _active


def disable() -> Optional[Recorder]:
    """Stop recording; -> the recorder that was recording (or None)."""
    global _active
    rec, _active = _active, None
    return rec


def records() -> List[SpanRecord]:
    """The spans of the current recording, or of the last one once it is
    stopped; empty when nothing was ever recorded."""
    return _last.records if _last is not None else []
