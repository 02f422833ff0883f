"""The port's spans: named host intervals on the profiler's clock, kept in
memory.

A span records while a ``torch.profiler`` run is recording in this
process, from any thread, or inside ``recording()``; nothing else
switches it. Its start and end are ``time.time_ns()``, the clock of the
profiler's events, so a reader joins the spans to a device trace by
time. Spans are not ``record_function`` ranges: a range that encloses
kernels gets a device-side copy in the trace, which would count as
device time.

Off, ``span()`` returns one shared no-op object: no timestamp, no
allocation, no lock. On, a span takes two ``time.time_ns()`` reads, a
push and a pop on its thread's stack and one list append. The buffer
holds at most ``CAP`` spans; the ones past it are counted in
``dropped``.

Names are ``vpr.<layer>.<part>``; ``id`` ties the spans of one call,
batch or request, across threads too.
"""

import contextlib
import threading
import time
from collections import namedtuple

from torch.autograd import profiler as _profiler

__all__ = ["Span", "CAP", "span", "add", "spans", "reset", "recording"]

Span = namedtuple("Span", "name start_ns end_ns thread parent id")

CAP = 1 << 20
dropped = 0
_done = []            # closed spans, as _Open objects, in the order they closed
_forced = 0           # depth of open recording() blocks
_forced_lock = threading.Lock()


class _Stack(threading.local):
    def __init__(self):
        self.open = []


_local = _Stack()


def _on():
    """Whether spans record: ``recording()`` is open, or a profiler run is
    recording (the profiler's module flag, which ``profile.start()`` sets
    for the whole process)."""
    return _forced > 0 or _profiler._is_profiler_enabled


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    __slots__ = ("name", "id", "start", "end", "thread", "parent")

    def __init__(self, name, id):
        self.name, self.id = name, id

    def __enter__(self):
        stack = _local.open
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.thread = threading.get_ident()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.time_ns()
        _local.open.pop()
        _keep(self)
        return False


def _keep(rec):
    global dropped
    if len(_done) >= CAP:
        dropped += 1
    else:
        _done.append(rec)


def span(name, id=None):
    """A context manager timing its body as the span ``name``."""
    if not _on():
        return _OFF
    return _Open(name, id)


def add(name, start_ns, end_ns, id=None):
    """A span measured by the caller (``time.time_ns()`` values), such as
    a wait that began on another thread; it has no parent."""
    if not _on():
        return
    rec = _Open(name, id)
    rec.start, rec.end = int(start_ns), int(end_ns)
    rec.thread, rec.parent = threading.get_ident(), None
    _keep(rec)


def spans():
    """The closed spans as ``Span`` records in order of start; ``parent``
    is the index of the enclosing span of the same thread in this list
    (``None`` for a root, or where the parent was still open)."""
    done = sorted(list(_done), key=lambda r: (r.start, -r.end))
    index = {id(r): i for i, r in enumerate(done)}
    return [Span(r.name, r.start, r.end, r.thread,
                 None if r.parent is None else index.get(id(r.parent)), r.id)
            for r in done]


def reset():
    """Forget every span and the count of drops."""
    global dropped
    _done.clear()
    dropped = 0


@contextlib.contextmanager
def recording():
    """Record spans inside the block, profiler or not."""
    global _forced
    with _forced_lock:
        _forced += 1
    try:
        yield
    finally:
        with _forced_lock:
            _forced -= 1
