"""The span recorder seam (counterpart of byol_tpu/observability/spans.py).

Only the no-op recorder exists in this slice: the engine and the service
open their spans through it, and it records nothing.  The flight recorder
and its Chrome-trace export come with the observability slice.
"""
from __future__ import annotations

import contextlib


class NullRecorder:
    enabled = False

    def span(self, name: str, **attrs):
        del name, attrs
        return contextlib.nullcontext()


NULL = NullRecorder()
