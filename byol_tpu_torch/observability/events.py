"""The strict-JSON convention of the run's records (counterpart of
``sanitize`` in byol_tpu/observability/events.py; the run log itself is
not ported yet, ROADMAP.md section 1 item 13).

Non-finite floats become the strings ``"NaN"`` / ``"Infinity"`` /
``"-Infinity"``, so a record written with ``json.dumps(...,
allow_nan=False)`` stays parseable by every standard JSON reader, and a NaN
metric neither crashes the write that records it nor leaves a bare NaN
token in the file.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np


def sanitize(obj: Any) -> Any:
    """JSON-strict deep copy of ``obj``: non-finite floats become strings,
    tuples and arrays become lists."""
    if isinstance(obj, dict):
        return {k: sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return sanitize(obj.tolist())
    if isinstance(obj, (float, np.floating)):
        f = float(obj)
        if math.isnan(f):
            return "NaN"
        if math.isinf(f):
            return "Infinity" if f > 0 else "-Infinity"
        return f
    return obj
