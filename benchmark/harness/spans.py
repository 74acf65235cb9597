"""The benchmark's host spans: (name, thread, start, end, attributes) on
``time.perf_counter``'s clock, kept in memory.

A :class:`Recorder` also serves as the ``recorder`` that the serving
stack takes, so the program's own ``serve/*`` spans land here beside the
benchmark's ``bench/*`` ones.  :data:`OFF` records nothing.
"""
from __future__ import annotations

import threading
import time
from typing import Any, List, NamedTuple


class Span(NamedTuple):
    name: str
    thread: int
    t0: float
    t1: float
    attrs: dict


class _Open:
    __slots__ = ("rec", "name", "attrs", "t0")

    def __init__(self, rec, name, attrs):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.rec.spans.append(Span(self.name, threading.get_ident(), self.t0,
                                   time.perf_counter(), self.attrs))
        return False


class Recorder:
    def __init__(self) -> None:
        self.spans: List[Span] = []     # list.append is atomic

    def span(self, name: str, **attrs: Any) -> _Open:
        return _Open(self, name, attrs)


class _Off:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _OffRecorder:
    spans: List[Span] = []

    def span(self, name: str, **attrs: Any) -> _Off:
        return _Off()


OFF = _OffRecorder()
