"""Spans of the port's layers: where in a request the host is, on the
profiler's clock, with the host synchronisations each one caused.

The port's code opens ``with trace.span("crt.bounce"):`` where the work
happens, and ``with trace.entry("crt.render"):`` at an entry point (a
render or a gradient step). Every name takes the prefix ``crt.``.
Outside ``recording()`` both return one shared object whose enter and
exit do nothing: no allocation, no clock read, no torch call. Inside it::

    with trace.recording() as rec:
        integrator.render_image(scene, cam, key)
    rec.spans      # one Span per span opened, in the order they opened
    rec.outside    # synchronisations while no span was open

A request id is new at an entry span that opens with no entry span above
it; every span below it carries that id, and an entry nested inside
another keeps the outer id (spans outside every entry carry 0). While a
``torch.profiler`` session is on, each span also enters a
``record_function`` of its name, so the profile and its Chrome trace
carry the layers. Timestamps are ``time.time_ns()``, the clock of the
profiler's events (the kineto result's ``trace_start_ns()`` plus an
event's start), read inside that range: a span's interval lies within its
profiler event's.

Synchronisations: on a host with a CUDA device the recording turns on
PyTorch's synchronisation debug mode in ``warn`` and counts each warning
it raises against the innermost open span of the thread that raised it.
The autograd engine replays its threads' warnings on the thread that
called ``backward``, when the call returns, so a backward's
synchronisations fall in the span around that call. On a host without
one nothing is counted (``Recording.counts_syncs`` is False).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import warnings

import torch

# what PyTorch's synchronisation debug mode says at each synchronisation;
# turning the mode on first in a process warns once more, a notice that
# is not one
SYNC_MESSAGE = "called a synchronizing CUDA operation"


@dataclasses.dataclass
class Span:
    """One opened span. ``parent``: the enclosing span's id on the same
    thread (0: none); ``request``: the id of the entry span above (0:
    none); times in ns on ``time.time_ns()``'s clock (``end_ns`` 0 while
    open); ``syncs``: the synchronisations counted while it was the
    innermost open span of its thread."""
    name: str
    id: int
    parent: int
    request: int
    thread: int
    start_ns: int
    end_ns: int = 0
    syncs: int = 0


class _Off:
    """The span outside a recording."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_recording = None  # the open Recording, or None


def span(name: str):
    """A span of ``name`` around the block that follows."""
    rec = _recording
    return _OFF if rec is None else _Open(rec, name, False)


def entry(name: str):
    """An entry span: a new request id unless an entry span is open above."""
    rec = _recording
    return _OFF if rec is None else _Open(rec, name, True)


class _Open:
    __slots__ = ("rec", "name", "is_entry", "span", "range")

    def __init__(self, rec, name, is_entry):
        self.rec, self.name, self.is_entry = rec, name, is_entry

    def __enter__(self):
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.span = self.rec._open(self.name, self.is_entry, time.time_ns())
        return self.span

    def __exit__(self, *exc):
        self.span.end_ns = time.time_ns()
        self.rec._close(self.span)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


class Recording:
    """The spans of one ``recording()``; see the module's docstring."""

    def __init__(self, counts_syncs: bool):
        self.counts_syncs = counts_syncs
        self.spans: list[Span] = []
        self.outside = 0
        self._stacks = threading.local()
        self._lock = threading.Lock()
        self._requests = 0

    def _stack(self) -> list:
        stack = getattr(self._stacks, "stack", None)
        if stack is None:
            stack = self._stacks.stack = []
        return stack

    def _open(self, name, is_entry, start_ns) -> Span:
        stack = self._stack()
        parent = stack[-1] if stack else None
        request = parent.request if parent is not None else 0
        with self._lock:
            if is_entry and not request:
                self._requests += 1
                request = self._requests
            s = Span(name, len(self.spans) + 1, parent.id if parent is not None else 0,
                     request, threading.get_ident(), start_ns)
            self.spans.append(s)
        stack.append(s)
        return s

    def _close(self, s: Span) -> None:
        stack = self._stack()
        if stack and stack[-1] is s:
            stack.pop()

    def _sync(self) -> None:
        stack = self._stack()
        with self._lock:
            if stack:
                stack[-1].syncs += 1
            else:
                self.outside += 1

    def requests(self) -> dict:
        """{request id: [its spans]} of the spans inside an entry span."""
        out = {}
        for s in self.spans:
            if s.request:
                out.setdefault(s.request, []).append(s)
        return out


@contextlib.contextmanager
def recording():
    """Record every span opened in the block (one recording at a time)."""
    global _recording
    if _recording is not None:
        raise RuntimeError("trace.recording() is already open")
    counts = torch.cuda.is_available()
    rec = Recording(counts)
    with warnings.catch_warnings():
        if counts:
            warnings.filterwarnings("always", message=SYNC_MESSAGE)
            shown = warnings.showwarning

            def showwarning(message, category, filename, lineno, file=None, line=None):
                if str(message).startswith(SYNC_MESSAGE):
                    rec._sync()
                else:
                    shown(message, category, filename, lineno, file, line)

            warnings.showwarning = showwarning
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        _recording = rec
        try:
            yield rec
        finally:
            _recording = None
            if counts:
                torch.cuda.set_sync_debug_mode(mode)
